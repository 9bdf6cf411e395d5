"""Implicit fields, level-set sampling and the scene models (port of
isopoints_tpu/models/__init__.py): the scene models live in implicit.py,
point.py and combined.py, the fields in fields.py."""

from isopoints_torch.models.fields import (
    FieldOutput,
    OccupancyField,
    RenderingNetwork,
    SDFField,
    SirenField,
    approximate_gradient,
    positional_embedder,
)
