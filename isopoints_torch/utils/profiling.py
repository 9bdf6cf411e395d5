"""Roofline accounting for the MLP evaluations (port of
isopoints_tpu/utils/profiling.py).

Given a measured time, `KernelRoofline` reports the achieved FLOP/s and
bytes/s against the card's peaks, and the speed-of-light time: the larger
of the FLOPs over the peak rate and the bytes over the memory rate. The
FLOPs and bytes are counted exactly as the JAX package counts them
(`mlp_eval_roofline`). The peaks are one H100 SXM's (NVIDIA's data sheet,
dense, at the 700 W limit; PERF.md §2): 989 TFLOP/s in bf16 on the tensor
cores, float32 products as three tf32 passes over 495 TFLOP/s, 67 TFLOP/s
for other float32 work, 3.35 TB/s of device memory.
"""

from dataclasses import dataclass
from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_F32_MMA_FLOPS = 495e12 / 3   # 3xTF32: a float32 product in three passes
PEAK_F32_FLOPS = 67e12            # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


@dataclass(frozen=True)
class KernelRoofline:
    name: str
    flops: float       # floating-point operations
    hbm_bytes: float   # bytes moved to and from device memory
    seconds: float     # measured time

    @property
    def achieved_flops(self) -> float:
        return self.flops / max(self.seconds, 1e-12)

    @property
    def achieved_bw(self) -> float:
        return self.hbm_bytes / max(self.seconds, 1e-12)

    def utilization(self, peak_flops: float = PEAK_F32_MMA_FLOPS,
                    peak_bw: float = PEAK_HBM_BYTES) -> Dict[str, float]:
        """Shares of the peaks, the speed-of-light time and its share of
        the measured time, and the bound ('compute' | 'memory')."""
        t_compute = self.flops / peak_flops
        t_memory = self.hbm_bytes / peak_bw
        sol = max(t_compute, t_memory)
        return {"flop_util": self.achieved_flops / peak_flops,
                "hbm_util": self.achieved_bw / peak_bw,
                "sol_seconds": sol,
                "sol_fraction": sol / max(self.seconds, 1e-12),
                "bound": "compute" if t_compute >= t_memory else "memory"}

    def report(self) -> str:
        u = self.utilization()
        return (f"{self.name}: {self.seconds * 1e3:.2f} ms | "
                f"{self.achieved_flops / 1e12:.2f} TFLOP/s "
                f"({u['flop_util'] * 100:.1f}% of {PEAK_F32_MMA_FLOPS / 1e12:.0f} TFLOP/s) | "
                f"{self.achieved_bw / 1e9:.1f} GB/s "
                f"({u['hbm_util'] * 100:.1f}% of {PEAK_HBM_BYTES / 1e12:.2f} TB/s) | "
                f"{u['sol_fraction'] * 100:.1f}% of speed-of-light "
                f"({u['bound']}-bound)")


def mlp_eval_roofline(name: str, n_points: int, layer_dims, seconds: float,
                      with_grad: bool = False, fused: bool = True) -> KernelRoofline:
    """The roofline of an MLP value (and forward-mode input gradient) over
    n points (profiling.py:61-86). layer_dims, e.g. [3, 256, 256, 256, 1];
    `fused`: the weights stay on chip (bytes = inputs, outputs and weights),
    else every layer's activations go through device memory."""
    flops = 0.0
    for d_in, d_out in zip(layer_dims[:-1], layer_dims[1:]):
        flops += 2.0 * n_points * d_in * d_out
        if with_grad:
            flops += 2.0 * n_points * 3 * d_in * d_out   # 3 tangent columns
    w_bytes = 4.0 * sum(a * b + b for a, b in zip(layer_dims[:-1], layer_dims[1:]))
    io_bytes = 4.0 * n_points * (layer_dims[0] + layer_dims[-1]
                                 + (3 if with_grad else 0))
    hbm = io_bytes + w_bytes
    if not fused:
        hbm += 4.0 * n_points * sum(layer_dims[1:-1]) * 2   # read + write a layer
    return KernelRoofline(name=name, flops=flops, hbm_bytes=hbm, seconds=seconds)
