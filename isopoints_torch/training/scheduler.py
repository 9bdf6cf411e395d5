"""Hyper-parameter annealing schedules (own copy of
isopoints_tpu/training/scheduler.py, which imports no JAX but which the
port may not import).

Parity: reference DSS/training/scheduler.py (`TrainerScheduler`):
geometric schedules with steps/gamma/limit for the iso-point count
(grow ×2), ray count (shrink ×0.6), projection tolerance (shrink ×0.5
while doubling proj_max_iters up to 50), photoconsistency weight
(grow), freespace/occupancy weights, and the BCE sharpness `sdf_alpha`
(grow to 100).

Pure function of the iteration — no mutable state (the reference
mutates trainer attributes in-place, scheduler.py:66-164); values are
Python floats/ints.
"""

from dataclasses import dataclass
from typing import Dict


def _geometric(init, it: int, steps: int, gamma: float, limit):
    if steps <= 0:
        return init
    val = init * (gamma ** (it // steps))
    if gamma >= 1.0:
        return min(val, limit)
    return max(val, limit)


@dataclass(frozen=True)
class TrainerScheduler:
    """Knob mirror of scheduler.py:10-64 ctor."""
    init_n_points_dss: int = 1000
    steps_n_points_dss: int = -1
    gamma_n_points_dss: float = 2.0
    limit_n_points_dss: int = 24000

    init_n_rays: int = 1024
    steps_n_rays: int = -1
    gamma_n_rays: float = 0.6
    limit_n_rays: int = 40

    init_proj_tolerance: float = 5e-5
    steps_proj_tolerance: int = -1
    gamma_proj_tolerance: float = 0.5
    limit_proj_tolerance: float = 5e-8

    init_lambda_rgb: float = 1.0
    steps_lambda_rgb: int = -1
    gamma_lambda_rgb: float = 1.0
    limit_lambda_rgb: float = 1.0

    init_lambda_freespace: float = 1.0
    steps_lambda_freespace: int = -1
    gamma_lambda_freespace: float = 1.0
    limit_lambda_freespace: float = 1.0

    init_lambda_occupied: float = 1.0
    steps_lambda_occupied: int = -1
    gamma_lambda_occupied: float = 1.0
    limit_lambda_occupied: float = 1.0

    init_sdf_alpha: float = 10.0
    steps_sdf_alpha: int = -1
    gamma_sdf_alpha: float = 2.0
    limit_sdf_alpha: float = 100.0

    init_proj_max_iters: int = 10
    limit_proj_max_iters: int = 50

    def at(self, it: int) -> Dict[str, float]:
        """Resolved hyper-parameters at iteration `it`."""
        proj_tol = _geometric(self.init_proj_tolerance, it,
                              self.steps_proj_tolerance,
                              self.gamma_proj_tolerance,
                              self.limit_proj_tolerance)
        # proj_max_iters doubles every tolerance-halving (scheduler.py:96-112)
        if self.steps_proj_tolerance > 0:
            n_halvings = it // self.steps_proj_tolerance
            proj_iters = min(self.init_proj_max_iters * (2 ** n_halvings),
                             self.limit_proj_max_iters)
        else:
            proj_iters = self.init_proj_max_iters
        return {
            "n_points_dss": int(_geometric(
                self.init_n_points_dss, it, self.steps_n_points_dss,
                self.gamma_n_points_dss, self.limit_n_points_dss)),
            "n_rays": int(_geometric(
                self.init_n_rays, it, self.steps_n_rays,
                self.gamma_n_rays, self.limit_n_rays)),
            "proj_tolerance": proj_tol,
            "proj_max_iters": int(proj_iters),
            "lambda_rgb": _geometric(
                self.init_lambda_rgb, it, self.steps_lambda_rgb,
                self.gamma_lambda_rgb, self.limit_lambda_rgb),
            "lambda_freespace": _geometric(
                self.init_lambda_freespace, it, self.steps_lambda_freespace,
                self.gamma_lambda_freespace, self.limit_lambda_freespace),
            "lambda_occupied": _geometric(
                self.init_lambda_occupied, it, self.steps_lambda_occupied,
                self.gamma_lambda_occupied, self.limit_lambda_occupied),
            "sdf_alpha": _geometric(
                self.init_sdf_alpha, it, self.steps_sdf_alpha,
                self.gamma_sdf_alpha, self.limit_sdf_alpha),
        }
