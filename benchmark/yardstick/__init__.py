"""The benchmark's frozen yardstick: FLOP and byte counts and the card's
peaks."""
