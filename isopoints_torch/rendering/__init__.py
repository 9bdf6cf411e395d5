"""The differentiable surface-splatting stack (port of
isopoints_tpu/rendering/__init__.py): rasterizer, compositor, lights,
textures and the point renderer. The CUDA kernels under it build at their
first launch, not at import."""

from isopoints_torch.rendering.compositor import (
    norm_weighted_sum_composite,
    weighted_sum_composite,
)
from isopoints_torch.rendering.lighting import (
    DirectionalLights,
    PointLights,
    apply_lighting,
    diffuse,
    specular,
)
from isopoints_torch.rendering.rasterizer import (
    Fragments,
    RasterizationSettings,
    SplatParams,
    compute_splat_params,
    rasterize_splats,
    visible_point_mask,
)
from isopoints_torch.rendering.renderer import RenderOutput, render_pointcloud
from isopoints_torch.rendering.texture import lighting_texture, neural_texture
