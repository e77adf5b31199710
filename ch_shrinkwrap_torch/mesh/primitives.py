"""Procedural test meshes: icosphere, plane, initial wrap surfaces.

Counterpart of the fixtures the reference builds from PYME spherical
harmonics helpers (tests/test_membrane_mesh.py:7-41)
plus the kNN-density initial surface (`wrap_start`,
ch_shrinkwrap/holepunch.py:88-112 — see
``models.membrane_mesh``).
"""

from __future__ import annotations

import numpy as np


def icosahedron():
    """Unit icosahedron (12 vertices, 20 faces, outward CCW winding)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    v /= np.linalg.norm(v, axis=1)[:, None]
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int32)
    return v, f


def icosphere(n_subdivision=3, radius=1.0, centre=(0.0, 0.0, 0.0)):
    """Icosahedron subdivided ``n_subdivision`` times, projected to the
    sphere of ``radius`` about ``centre``.  Returns (V, F)."""
    v, f = icosahedron()
    for _ in range(n_subdivision):
        v, f = _subdivide(v, f)
        v /= np.linalg.norm(v, axis=1)[:, None]
    v = v * radius + np.asarray(centre, dtype=np.float64)[None, :]
    return v.astype(np.float32), f


def _subdivide(v, f):
    """Loop-style 1->4 subdivision with shared midpoints."""
    a, b = f, f[:, [1, 2, 0]]
    lo = np.minimum(a, b).ravel()
    hi = np.maximum(a, b).ravel()
    key = lo.astype(np.int64) << 32 | hi.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    mids = 0.5 * (v[uniq >> 32] + v[uniq & 0xFFFFFFFF])
    mid_idx = (len(v) + inv).reshape(f.shape)

    v_new = np.vstack([v, mids])
    m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    v0, v1, v2 = f[:, 0], f[:, 1], f[:, 2]
    f_new = np.vstack([
        np.stack([v0, m01, m20], 1),
        np.stack([m01, v1, m12], 1),
        np.stack([m20, m12, v2], 1),
        np.stack([m01, m12, m20], 1),
    ]).astype(np.int32)
    return v_new, f_new


def planar_grid(a=1.0, n_subdivision=1):
    """Triangulated square [0, a]^2 in the z=0 plane (reference
    tests/test_membrane_mesh.py:23-41)."""
    n = n_subdivision + 1
    p = np.linspace(0.0, a, n)
    X, Y = np.meshgrid(p, p, indexing='ij')
    v = np.stack([X.ravel(), Y.ravel(), np.zeros(n * n)], axis=1)

    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing='ij')
    ll = (i * n + j).ravel()
    lr = ((i + 1) * n + j).ravel()
    ul = (i * n + j + 1).ravel()
    ur = ((i + 1) * n + j + 1).ravel()
    f = np.vstack([np.stack([ll, lr, ur], 1),
                   np.stack([ll, ur, ul], 1)]).astype(np.int32)
    return v.astype(np.float32), f


def bounding_icosphere(points, n_subdivision=3, margin=1.1):
    """Icosphere enclosing a point cloud — the default wrap start."""
    points = np.asarray(points)
    centre = points.mean(0)
    r = float(np.max(np.linalg.norm(points - centre[None, :], axis=1)))
    return icosphere(n_subdivision, radius=margin * r, centre=centre)
