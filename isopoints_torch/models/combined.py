"""Combined model: implicit SDF + persistent iso-point cloud (port of
isopoints_tpu/models/combined.py:58-85, 272-276).

This slice ports the warm-up: without projection (`project=False`, or no
iso-points yet) the forward is the pure IDR path of ImplicitModel and the
iso-point buffers pass through. The projected phase (visibility rasters,
kNN spacing, Newton projection) is ROADMAP slice 3; `project=True`
raises NotImplementedError.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from isopoints_torch.core.camera import PerspectiveCamera
from isopoints_torch.models.implicit import ImplicitConfig, ImplicitModel


@dataclass(frozen=True)
class CombinedConfig:
    max_iso_per_batch: int = 1000
    n_points_per_cloud: int = 5000
    n_insurface_points_per_ray: int = 64
    visibility_image_size: int = 256


class CombinedModel(ImplicitModel):
    """Implicit model + persistent iso-points (combined_modeling.Model)."""

    def __init__(self, decoder, cfg: ImplicitConfig = ImplicitConfig(),
                 combined_cfg: CombinedConfig = CombinedConfig()):
        super().__init__(decoder, cfg)
        self.ccfg = combined_cfg

    def init_points(self, generator: Optional[torch.Generator] = None,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Initial iso-point buffer: random cube points (1, n, 3) and an
        all-true mask (combined.py:80-85)."""
        n = self.ccfg.n_points_per_cloud
        pts = (torch.rand((1, n, 3), generator=generator, device=device)
               - 0.5) * 1.5
        return pts, torch.ones((1, n), dtype=torch.bool, device=device)

    def forward(self, ndc_pixels, img, mask_img, camera: PerspectiveCamera,
                u: Optional[torch.Tensor], points=None, points_mask=None,
                lights=None, project: bool = True, training: bool = True):
        """Returns (ModelOutput, points, points_mask)."""
        if project and points is not None:
            raise NotImplementedError(
                "the projected phase of the combined model is not ported yet "
                "(ROADMAP 'Slices of the port' 3)")
        out = super().forward(ndc_pixels, img, mask_img, camera, u,
                              lights=lights, training=training)
        return out, points, points_mask
