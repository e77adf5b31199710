"""Face/vertex normals and areas on padded torch tensors.

Counterpart of the JAX package's ``ops/normals.py``: gathers over the
padded face table plus folds onto vertices through the ordered segment
sum (``cuda_scatter.segment_sum_ordered``: a kernel on the card, the
same bits on every run).
"""

from __future__ import annotations

import torch

from . import cuda_scatter


def face_geometry(positions, faces, f_mask, tri=None):
    """(unit normals (Fp,3), areas (Fp,)) with padding rows zeroed.
    Pass ``tri = positions[faces]`` to reuse an existing gather."""
    if tri is None:
        tri = positions[faces.long()]               # (Fp, 3, 3)
    fm = f_mask.to(positions.dtype)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                           dim=-1)
    nn = torch.sqrt((n * n).sum(-1))
    areas = 0.5 * nn * fm
    normals = n / torch.clamp(nn, min=1e-12)[:, None] * fm[:, None]
    return normals, areas


def vertex_normal_corners(positions, faces, f_mask, tri=None):
    """Per-corner contributions (Fp, 3, 3) of the angle-weighted vertex
    normals, to be summed onto ``faces.reshape(-1)``."""
    if tri is None:
        tri = positions[faces.long()]               # (Fp, 3, 3)
    fn, _ = face_geometry(positions, faces, f_mask, tri=tri)
    e_next = tri[:, [1, 2, 0]] - tri                # (Fp, 3, 3)
    e_prev = tri[:, [2, 0, 1]] - tri
    dot = (e_next * e_prev).sum(-1)
    crs = torch.linalg.cross(e_next, e_prev, dim=-1)
    sin = torch.sqrt((crs * crs).sum(-1))
    ang = torch.atan2(sin, dot) * f_mask.to(positions.dtype)[:, None]
    return fn[:, None, :] * ang[:, :, None]         # (Fp, 3, 3)


def normalize_vertex_normals(vn):
    """Unit-normalize summed corner contributions."""
    norm = torch.sqrt((vn * vn).sum(-1))
    return vn / torch.clamp(norm, min=1e-12)[:, None]


def vertex_normals(positions, faces, f_mask, n_vertices, tri=None):
    """Angle-weighted unit vertex normals."""
    corners = vertex_normal_corners(positions, faces, f_mask, tri=tri)
    vn = cuda_scatter.segment_sum_ordered(corners.reshape(-1, 3),
                                          faces.reshape(-1), n_vertices)
    return normalize_vertex_normals(vn)


def vertex_areas(positions, faces, f_mask, n_vertices):
    """Sum of incident face areas per vertex."""
    _, areas = face_geometry(positions, faces, f_mask)
    return cuda_scatter.segment_sum_ordered(
        areas[:, None].expand(-1, 3).reshape(-1), faces.reshape(-1),
        n_vertices)
