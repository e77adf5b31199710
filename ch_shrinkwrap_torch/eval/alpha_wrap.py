"""CGAL Alpha_wrap_3 wrapper (competitor baseline).

Parity with the reference ch_shrinkwrap/alpha_wrap.py:11-40.  CGAL's
python bindings are an optional host dependency (eval-only).
"""

from __future__ import annotations

import numpy as np


def cgal_vertices_faces_triangle_mesh(P):
    """Convert a CGAL Polyhedron_3 into (vertices, faces) arrays."""
    vertices = np.zeros((P.size_of_vertices(), 3), dtype=np.float32)
    vid = {}
    for i, v in enumerate(P.vertices()):
        p = v.point()
        vertices[i] = (p.x(), p.y(), p.z())
        vid[v] = i
    faces = np.zeros((P.size_of_facets(), 3), dtype=np.int32)
    for i, f in enumerate(P.facets()):
        h = f.halfedge()
        faces[i] = (vid[h.vertex()], vid[h.next().vertex()],
                    vid[h.next().next().vertex()])
    return vertices, faces


def alpha_wrap(points, alpha=20.0, offset=0.001):
    """Alpha-wrap a point cloud; returns (vertices, faces)."""
    try:
        from CGAL.CGAL_Alpha_wrap_3 import alpha_wrap_3
        from CGAL.CGAL_Kernel import Point_3
        from CGAL.CGAL_Polyhedron_3 import Polyhedron_3
    except ImportError as e:
        raise RuntimeError(
            'alpha_wrap requires the optional CGAL python bindings '
            '(host-side competitor baseline, not part of the fit path)'
        ) from e

    pts = [Point_3(float(x), float(y), float(z)) for x, y, z in points]
    Q = Polyhedron_3()
    alpha_wrap_3(pts, alpha, offset, Q)
    return cgal_vertices_faces_triangle_mesh(Q)
