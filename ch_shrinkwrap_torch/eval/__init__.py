"""Evaluation helpers; so far only ``delaunay_utils``, which
``MembraneMesh.delaunay_remesh`` needs."""
