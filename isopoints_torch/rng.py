"""Seeded random-number discipline (port of isopoints_tpu/rng.py).

`GeneratorChain` takes the place of the JAX `KeyChain`: each `next()`
returns a fresh `torch.Generator` seeded from the chain's own host
generator, so a training loop never reuses a stream and a run is a pure
function of its seed. Torch generators and JAX keys never give the same
numbers; tests that compare the two packages make their draws with numpy
or JAX and pass them in explicitly.
"""

import random

import numpy as np
import torch


def set_deterministic_seed(seed: int = 0) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    `torch.Generator` seeded with `seed` (rng.py:14-19, which returns a
    root JAX key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)



class GeneratorChain:
    """Dispenser of independent seeded generators on `device`."""

    def __init__(self, seed: int, device="cpu"):
        self._host = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)

    def next(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._host))
        return torch.Generator(device=self.device).manual_seed(seed)

    # The chain's position is training state: a resumed run restores it,
    # so that it draws the same numbers at the same iterations as the
    # uninterrupted run (KeyChain.key_data / set_key_data).
    def state(self) -> np.ndarray:
        """The host generator's state as a uint8 array (npz-serialisable)."""
        return self._host.get_state().numpy().copy()

    def set_state(self, state) -> None:
        """Restore the chain to a `state()` snapshot."""
        self._host.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))
