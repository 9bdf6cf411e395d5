"""Point clouds and cameras (port of isopoints_tpu/core/__init__.py)."""

from isopoints_torch.core.camera import (
    CameraSampler,
    PerspectiveCamera,
    look_at_rotation,
    look_at_view_transform,
)
from isopoints_torch.core.cloud import PointCloud, PointCloudFilters
