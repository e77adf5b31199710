"""Simulation: signed-distance primitives (``sdf``), the shape library
(``shape``) and SMLM point-cloud simulation (``pointcloud``), host-side
numpy drawn from a seeded generator in the JAX package's order."""

from . import sdf, shape, pointcloud
from .pointcloud import (
    points_from_sdf,
    generate_smlm_pointcloud_from_shape,
    smlmify_points,
)
