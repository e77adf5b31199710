"""Evaluation: SDF-oracle and point-cloud metrics (``metrics``), the
sweep harness (``harness``), the Delaunay hull surface
(``delaunay_utils``) and the optional competitor wrappers
(``screened_poisson``, ``alpha_wrap``)."""
from .metrics import points_from_mesh, average_squared_distance
