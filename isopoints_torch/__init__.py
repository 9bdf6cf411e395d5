"""isopoints_torch — the PyTorch/CUDA port of isopoints_tpu for NVIDIA
Hopper (H100, sm_90a).

The JAX package `isopoints_tpu` is the reference; every module here has
one counterpart there, under the same tree and module name. This package
imports `torch` and never `jax` or `isopoints_tpu`. Padded `(B, N, ...)`
tensors plus bool masks at the public functions, Linear weights stored
(out, in), as in the JAX package. The TPU's Pallas kernels on the ported
path are hand-written CUDA kernels under `csrc/`, built with `nvcc` at
first use (ops/_build.py); a CPU tensor takes each kernel's plain PyTorch
twin instead.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

from isopoints_torch.debug import (
    DebugState,
    get_debugging_mode,
    get_debugging_tensor,
    set_debugging_mode_,
)
from isopoints_torch.logger import get_logger
from isopoints_torch.rng import GeneratorChain, set_deterministic_seed

__all__ = ["get_logger", "DebugState", "set_debugging_mode_",
           "get_debugging_mode", "get_debugging_tensor", "GeneratorChain",
           "set_deterministic_seed", "__version__"]
