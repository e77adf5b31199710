"""SDF-based hole punching (the reference's alternative path).

Counterpart of ch_shrinkwrap/holepunch.py:3-85:
instead of explicit topological surgery, carve unsupported regions by
re-meshing an implicit surface — the mesh's signed distance field
intersected with the *masked* distance field of its point-supported
faces, shifted by ``offset``.  Faces with point influence below
``pi_threshold`` are "unsupported"; where the full surface is much
closer than any supported face, material is removed, opening
fenestrations.  The result is re-extracted with marching tetrahedra and
remeshed.
"""

from __future__ import annotations

import numpy as np


def masked_distance_to_mesh(points, mesh, face_mask=None, tree=None):
    """Unsigned-ish distance to the centers of masked faces (the
    reference uses 5-NN triangle SDFs, holepunch.py:3-45; face-center
    distance at our mesh resolutions is within an edge length)."""
    from scipy.spatial import cKDTree
    if face_mask is None:
        face_mask = np.ones(mesh.faces.shape[0], dtype=bool)
    if tree is None:
        centers = mesh.vertices[mesh.faces[face_mask]].mean(1)
        tree = cKDTree(centers)
    d, _ = tree.query(np.asarray(points), k=1, workers=-1)
    return d


def masked_intersection_sdf(points, mesh, face_mask, offset=10.0,
                            tree=None, tree_c=None):
    """max(d_full - d_supported - offset, d_full): equal to the plain
    mesh SDF near supported faces, pushed positive (carved away) where
    only unsupported faces are nearby (holepunch.py:48-54)."""
    from ..eval.delaunay_utils import distance_to_mesh
    d1 = distance_to_mesh(points, mesh)
    d2 = masked_distance_to_mesh(points, mesh, face_mask=face_mask,
                                 tree=tree_c)
    return np.maximum(d1 - d2 - offset, d1)


def punch_holes_sdf(mesh, offset=10.0, pi_threshold=0.0, grid_n=64):
    """Carve unsupported regions and re-extract the surface
    (holepunch.py:57-85).  Requires ``mesh.point_influence`` (a fitted
    MembraneMesh).  Returns a new MembraneMesh on the same torch device.
    """
    from scipy.spatial import cKDTree
    from ..mesh.marching import surface_from_function
    from ..mesh.remesh import remesh
    from .membrane_mesh import MembraneMesh

    pi = mesh.point_influence
    face_mask = pi[mesh.faces].max(1) > pi_threshold
    if face_mask.all() or not face_mask.any():
        return mesh

    centers_c = mesh.vertices[mesh.faces[face_mask]].mean(1)
    tree_c = cKDTree(centers_c)

    def f(p):
        return masked_intersection_sdf(p, mesh, face_mask, offset,
                                       tree_c=tree_c)

    lo = mesh.vertices.min(0) - 2 * offset
    hi = mesh.vertices.max(0) + 2 * offset
    step = float((hi - lo).max()) / grid_n
    v, fc = surface_from_function(
        f, (lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]), step)
    out = MembraneMesh(v, fc, device=mesh.device)
    out.repair()
    remesh(out, n=3, target_edge_length=mesh._mean_edge_length,
           n_relax=0)
    # carry over fit configuration
    for k in ('kc', 'kg', 'c0', 'step_size', 'remesh_frequency',
              'delaunay_remesh_frequency', 'delaunay_eps',
              'neck_threshold_low', 'neck_threshold_high',
              'neck_first_iter', 'shrink_weight'):
        setattr(out, k, getattr(mesh, k))
    out._points = mesh._points
    out._sigma = mesh._sigma
    return out
