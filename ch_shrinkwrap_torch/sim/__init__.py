"""Simulation helpers; so far only the signed-distance primitives
(``sdf``) that ``eval.delaunay_utils`` needs."""

from . import sdf
