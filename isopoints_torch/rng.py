"""Seeded random-number discipline (port of isopoints_tpu/rng.py).

`GeneratorChain` takes the place of the JAX `KeyChain`: each `next()`
returns a fresh `torch.Generator` seeded from the chain's own host
generator, so a training loop never reuses a stream and a run is a pure
function of its seed. Torch generators and JAX keys never give the same
numbers; tests that compare the two packages make their draws with numpy
or JAX and pass them in explicitly.
"""

import torch


class GeneratorChain:
    """Dispenser of independent seeded generators on `device`."""

    def __init__(self, seed: int, device="cpu"):
        self._host = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)

    def next(self) -> torch.Generator:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._host))
        return torch.Generator(device=self.device).manual_seed(seed)
