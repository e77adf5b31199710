"""Delaunay / Voronoi utilities.

Capability parity with ch_shrinkwrap/delaunay_utils.py:
tetrahedralization-based outer-surface extraction (orient_simps :9,
tris_from_delaunay :50, surf_from_delaunay :86, del_simps :108,
ext_simps :132, empty_simps :160, greedy_ext_simps :246,
greedy_empty_simps :314) and Amenta-Bern Voronoi poles
(voronoi_poles :398, clean_neg_voronoi_poles :452).  The reference's
O(n^2) repeated-argmax flood fills are re-implemented as heap-based
priority flood fills; the per-simplex point-in-tet loop is vectorized
with a cKDTree prefilter.
"""

from __future__ import annotations

import heapq

import numpy as np
import scipy.spatial

from ..sim import sdf as _sdf


def distance_to_mesh(points, mesh, smooth=False):
    """Signed distance to a mesh (negative inside), host-side: nearest
    face center + normal-sign test (replaces PYME
    isosurface.distance_to_mesh)."""
    from scipy.spatial import cKDTree
    centers = mesh.vertices[mesh.faces].mean(1)
    tree = cKDTree(centers)
    d, fi = tree.query(np.asarray(points, dtype=np.float64), k=1,
                       workers=-1)
    n = mesh.face_normals[fi]
    s = ((np.asarray(points) - centers[fi]) * n).sum(1)
    return np.sign(s) * d


def _simplices(d):
    if isinstance(d, scipy.spatial.Delaunay):
        return d.simplices
    return d


def orient_simps(d, v):
    """Wind each simplex so oriented surface triangles point outward
    (reference :9-48)."""
    d = np.array(_simplices(d), copy=True)
    v_tri = v[d]
    centroid = v_tri.mean(1)
    v21 = v_tri[:, 1, :] - v_tri[:, 2, :]
    v23 = v_tri[:, 3, :] - v_tri[:, 2, :]
    n123 = np.cross(v23, v21, axis=1)
    orientation = np.sign((n123 * (v_tri[:, 1, :] - centroid)).sum(1))
    mask = orientation == -1
    tmp = np.copy(d[mask, 3])
    d[mask, 3] = d[mask, 2]
    d[mask, 2] = tmp
    return d


def tris_from_delaunay(d, return_index=False, oriented=False):
    """All 4 triangles of each simplex (reference :50-84)."""
    d = _simplices(d)
    if oriented:
        # wound so that (v1-v0) x (v2-v0) points out of the simplex
        # (the reference's list at :77 targets PYME's winding; ours is
        # the reverse)
        tris = np.vstack([d[:, [0, 1, 2]], d[:, [1, 3, 2]],
                          d[:, [3, 0, 2]], d[:, [0, 3, 1]]])[:, ::-1]
    else:
        tris = np.vstack([d[:, :3], d[:, 1:], d[:, [0, 2, 3]],
                          d[:, [0, 1, 3]]])
    if return_index:
        inds = np.hstack(4 * [np.arange(d.shape[0])])
        return tris, inds
    return tris


def surf_from_delaunay(d, oriented=True):
    """Valence-one (boundary) triangles of the complex (reference
    :86-106)."""
    tris = tris_from_delaunay(d, oriented=oriented)
    _, inds, counts = np.unique(np.sort(tris, axis=1), axis=0,
                                return_index=True, return_counts=True)
    return tris[inds[counts == 1]]


def del_simps(d, inds):
    d = _simplices(d)
    mask = np.ones(d.shape[0], dtype=bool)
    mask[inds] = False
    return d[mask, :]


def ext_simps(d, mesh):
    """Simplices whose centroids lie outside the mesh (reference
    :132-158)."""
    d = _simplices(d)
    v = mesh.vertices
    simp_centers = np.mean(v[d], axis=1)
    simp_dist = distance_to_mesh(simp_centers, mesh)
    return np.flatnonzero(simp_dist > 0)


def empty_simps(d, v, pts, eps=0.0):
    """Simplices containing no points of ``pts`` (reference :160-244),
    vectorized with a KDTree circumball prefilter."""
    d = _simplices(d)
    tree = scipy.spatial.cKDTree(pts)
    out = np.zeros(d.shape[0], dtype=bool)
    vs_all = v[d]
    centroids = vs_all.mean(1)
    radii = np.linalg.norm(vs_all - centroids[:, None, :],
                           axis=2).max(1) + abs(eps)
    for i in range(d.shape[0]):
        cand = tree.query_ball_point(centroids[i], radii[i] * 1.5)
        if not cand:
            out[i] = True
            continue
        inside = _sdf.tetrahedron(pts[cand], *vs_all[i]) <= eps
        out[i] = not inside.any()
    return np.flatnonzero(out)


def _simplex_adjacency(d):
    """Face-sharing simplex adjacency lists via shared triangles."""
    tris, simp_idxs = tris_from_delaunay(d, return_index=True)
    _, invs = np.unique(np.sort(tris, axis=1), axis=0,
                        return_inverse=True)
    order = np.argsort(invs, kind='stable')
    sinv = invs[order]
    ssimp = simp_idxs[order]
    starts = np.searchsorted(sinv, np.arange(sinv.max() + 2))
    adj = [[] for _ in range(d.shape[0])]
    for g in range(len(starts) - 1):
        grp = ssimp[starts[g]:starts[g + 1]]
        if len(grp) == 2:
            adj[grp[0]].append(grp[1])
            adj[grp[1]].append(grp[0])
    return adj


def greedy_ext_simps(d, mesh, oriented=True):
    """Flood-fill exterior simplices from the furthest boundary simplex
    inward until the mesh surface stops the fill (reference :246-312),
    as a heap-based priority flood."""
    d = _simplices(d)
    v = mesh.vertices
    simp_centers = np.mean(v[d], axis=1)
    simp_dist = distance_to_mesh(simp_centers, mesh)

    tris, simp_idxs = tris_from_delaunay(d, return_index=True,
                                         oriented=oriented)
    _, inds, counts = np.unique(np.sort(tris, axis=1), axis=0,
                                return_index=True, return_counts=True)
    boundary = np.zeros(d.shape[0], dtype=bool)
    boundary[simp_idxs[inds[counts == 1]]] = True

    adj = _simplex_adjacency(d)
    visited = np.zeros(d.shape[0], dtype=bool)
    to_del = np.zeros(d.shape[0], dtype=bool)
    heap = [(-simp_dist[i], i) for i in np.flatnonzero(boundary)]
    heapq.heapify(heap)
    while heap:
        negd, i = heapq.heappop(heap)
        if visited[i] or -negd <= 0:
            continue
        visited[i] = True
        to_del[i] = True
        for j in adj[i]:
            if not visited[j]:
                heapq.heappush(heap, (-simp_dist[j], j))
    return np.flatnonzero(to_del)


def greedy_empty_simps(d, mesh, pts, eps=1.0, oriented=True):
    """Flood-fill empty simplices from the boundary; a simplex is
    carved when it and enough neighbors contain no points (reference
    :314-396)."""
    d = _simplices(d)
    v = mesh.vertices
    simp_centers = np.mean(v[d], axis=1)
    simp_dist = distance_to_mesh(simp_centers, mesh)

    tris, simp_idxs = tris_from_delaunay(d, return_index=True,
                                         oriented=oriented)
    _, inds, counts = np.unique(np.sort(tris, axis=1), axis=0,
                                return_index=True, return_counts=True)
    boundary = np.zeros(d.shape[0], dtype=bool)
    boundary[simp_idxs[inds[counts == 1]]] = True

    adj = _simplex_adjacency(d)
    visited = np.zeros(d.shape[0], dtype=bool)
    del_count = np.zeros(d.shape[0], dtype=int)
    heap = [(-simp_dist[i], i) for i in np.flatnonzero(boundary)]
    heapq.heapify(heap)
    while heap:
        _, i = heapq.heappop(heap)
        if visited[i]:
            continue
        visited[i] = True
        vs = v[d[i]]
        n_inside = np.sum(_sdf.tetrahedron(pts, *vs) <= eps)
        if n_inside != 0:
            continue
        del_count[i] += 1
        for j in adj[i]:
            del_count[j] += 1
            if not visited[j]:
                heapq.heappush(heap, (-simp_dist[j], j))
    return np.flatnonzero(del_count > 3)


def voronoi_poles(vor, point_normals, dot_threshold=1.0):
    """Amenta-Bern positive/negative Voronoi poles, vectorized over all
    cells at once (no per-point Python loop; counterpart of the
    reference's per-cell walk, delaunay_utils.py:398-450).  -1 marks a
    pole at infinity (unbounded convex-hull cell) or an empty region.

    Per cell: the positive pole is the Voronoi vertex farthest from the
    generating point (or the point normal direction, for unbounded
    cells); the negative pole is the farthest vertex v whose offset
    dn = v - p satisfies ``dot(pole_dir, dn) < dot_threshold``.

    ``dot_threshold`` resolves a reference quirk: its comment says
    "negative dot product" but its code tests ``< 1`` on an
    UNNORMALIZED dot (reference :446-447), admitting near-orthogonal
    and slightly-forward vertices.  The default 1.0 keeps the reference
    behavior (the skeleton path was tuned against it); pass 0.0 for the
    strict Amenta-Bern construction — validated on a capsule medial
    axis in tests/test_skeleton.py.

    One deliberate fix vs the reference: it only detects the infinite
    vertex when it sits at list position 0 of the region; scipy makes
    no ordering guarantee, so we detect it at any position.
    """
    sz = len(vor.point_region)
    p_pos = np.full(sz, -1, dtype=int)
    p_neg = np.full(sz, -1, dtype=int)

    regions = [vor.regions[r] for r in vor.point_region]
    lens = np.array([len(r) for r in regions], dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return p_pos, p_neg
    owner = np.repeat(np.arange(sz), lens)
    cells = np.fromiter((v for r in regions for v in r),
                        dtype=np.int64, count=total)

    inf_mask = cells == -1
    dn = vor.vertices[np.where(inf_mask, 0, cells)] - vor.points[owner]
    dist = np.where(inf_mask, -np.inf, np.linalg.norm(dn, axis=1))

    has_inf = np.zeros(sz, dtype=bool)
    has_inf[owner[inf_mask]] = True
    n_finite = lens - np.bincount(owner[inf_mask], minlength=sz)

    # entries of each cell are contiguous in any owner-primary lexsort,
    # so each cell's maximum sits at its segment end; -pos_in_cell as
    # the tie key reproduces np.argmax's first-on-ties choice
    starts = np.cumsum(lens) - lens
    ends = np.cumsum(lens) - 1
    pos_in_cell = np.arange(total) - starts[owner]
    sel_ends = np.clip(ends, 0, None)

    far = np.lexsort((-pos_in_cell, dist, owner))[sel_ends]
    bounded = (lens > 0) & ~has_inf
    p_pos[bounded] = cells[far[bounded]]

    # pole direction: offset to the positive pole, or the point normal
    # for unbounded cells (reference :430-440)
    pole_dir = np.where(has_inf[:, None], point_normals, dn[far])

    s = (pole_dir[owner] * dn).sum(1) < dot_threshold
    # reference argmax(s * dist): farthest qualifying vertex, falling
    # back to the first finite vertex when none qualifies (score 0)
    score = np.where(inf_mask, -np.inf, np.where(s, dist, 0.0))
    best = np.lexsort((-pos_in_cell, score, owner))[sel_ends]
    has_fin = (lens > 0) & (n_finite > 0)
    p_neg[has_fin] = cells[best[has_fin]]
    return p_pos, p_neg


def clean_neg_voronoi_poles(mesh, poles):
    """Keep only negative poles strictly inside the mesh (reference
    :452-459)."""
    d = distance_to_mesh(poles, mesh)
    return poles[d < 0.0, :]


CORNER_ANGLE = 3 * np.pi / 2


def _face_edge_tables(faces):
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [2, 0]]], axis=0)
    order = np.arange(len(edges))
    # interleave like the reference layout (edge i of face f at 3f+i)
    edges = np.sort(edges.reshape(3, -1, 2).transpose(1, 0, 2)
                    .reshape(-1, 2), axis=1)
    uniq, idxs, counts = np.unique(edges, axis=0, return_inverse=True,
                                   return_counts=True)
    return edges, uniq, idxs, counts


def _face_normals_of(faces, v):
    v1 = v[faces[:, 1]]
    a = v[faces[:, 0]] - v1
    b = v[faces[:, 2]] - v1
    n = np.cross(a, b, axis=1)
    nn = np.linalg.norm(n, axis=1)
    with np.errstate(invalid='ignore', divide='ignore'):
        n = np.where(nn[:, None] > 0, n / np.maximum(nn, 1e-30)[:, None],
                     0.0)
    return n, nn, a, b


def remove_singular_faces(faces, v):
    """Prune a candidate triangle soup to a cleaner surface (reference
    :463-552): drop sliver triangles (area < 10% of their circumcircle),
    unshared faces, sharp corners, and all but the two most-aligned
    faces on over-shared edges."""
    norms, nn, a, b = _face_normals_of(faces, v)
    _, uniq, idxs, counts = _face_edge_tables(faces)

    kept = np.ones(faces.shape[0], dtype=bool)

    a_n = np.linalg.norm(a, axis=1)
    b_n = np.linalg.norm(b, axis=1)
    ab_n = np.linalg.norm(a - b, axis=1)
    with np.errstate(invalid='ignore', divide='ignore'):
        circumradius = a_n * b_n * ab_n / np.maximum(2 * nn, 1e-30)
        adiff = 0.5 * nn / np.maximum(np.pi * circumradius ** 2, 1e-30)
    kept[adiff < 0.1] = False

    face_of = np.arange(3 * faces.shape[0]) // 3
    for i in np.flatnonzero(counts == 1):
        kept[face_of[np.flatnonzero(idxs == i)[0]]] = False

    for i in np.flatnonzero(counts == 2):
        cf = face_of[np.flatnonzero(idxs == i)]
        dot = np.abs((norms[cf[0]] * norms[cf[1]]).sum())
        if np.arccos(np.clip(dot, -1, 1)) > CORNER_ANGLE:
            kept[cf] = False

    for i in np.flatnonzero(counts > 2):
        cf = face_of[np.flatnonzero(idxs == i)]
        dots = np.abs(norms[cf] @ norms[cf].T)
        np.fill_diagonal(dots, -2)
        j, k = np.unravel_index(np.argmax(dots), dots.shape)
        if np.arccos(np.clip(dots[j, k], -1, 1)) > CORNER_ANGLE:
            kept[cf] = False
        else:
            drop = np.ones(len(cf), dtype=bool)
            drop[[j, k]] = False
            kept[cf[drop]] = False

    return faces[kept]


def construct_outer_surface(faces, v, starting_face=0):
    """Greedy flood over edge adjacency keeping a singularity-free
    surface (reference :555-622): visit faces breadth-first from
    ``starting_face``, never letting an edge exceed two incident kept
    faces, preferring the smoothest normal transition on over-shared
    edges and refusing sharp corners."""
    norms, _, _, _ = _face_normals_of(faces, v)
    _, uniq, idxs, counts = _face_edge_tables(faces)
    face_of = np.arange(3 * faces.shape[0]) // 3

    # edge id -> incident face list
    order = np.argsort(idxs, kind='stable')
    sidx = idxs[order]
    sface = face_of[order]
    starts = np.searchsorted(sidx, np.arange(len(uniq) + 1))

    def edge_faces(e):
        return sface[starts[e]:starts[e + 1]]

    visited = np.zeros(faces.shape[0], dtype=bool)
    kept_edges = np.zeros(len(uniq), dtype=int)
    kept = np.zeros(faces.shape[0], dtype=bool)
    stack = [starting_face]

    face_edge_ids = idxs.reshape(-1, 3)

    while stack:
        cur = stack.pop()
        if visited[cur]:
            continue
        visited[cur] = True
        eids = face_edge_ids[cur]
        if (counts[eids] == 1).any():
            continue
        if (kept_edges[eids] == 2).any():
            continue
        kept[cur] = True
        kept_edges[eids] += 1

        for e in eids:
            cf = edge_faces(e)
            if counts[e] == 2:
                other = cf[cf != cur]
                if len(other) != 1:
                    continue
                dot = np.abs((norms[cur] * norms[other[0]]).sum())
                if np.arccos(np.clip(dot, -1, 1)) > CORNER_ANGLE:
                    continue
                stack.append(int(other[0]))
            elif counts[e] > 2:
                others = cf[cf != cur]
                if len(others) == 0:
                    continue
                dots = np.abs(norms[others] @ norms[cur])
                b = int(np.argmax(dots))
                if np.arccos(np.clip(dots[b], -1, 1)) > CORNER_ANGLE:
                    continue
                stack.append(int(others[b]))

    return faces[kept]


def sliver_simps(d, v, sigma0=0.06, rho0=2.0):
    """Indices of sliver tetrahedra (shape quality V/l^3 below sigma0
    with bounded radius-edge ratio; reference :665-721 after Li 2000)."""
    d = _simplices(d)
    v_tri = v[d]
    v21 = v_tri[:, 1] - v_tri[:, 2]
    v23 = v_tri[:, 3] - v_tri[:, 2]
    v20 = v_tri[:, 0] - v_tri[:, 2]
    v30 = v_tri[:, 0] - v_tri[:, 3]
    v10 = v_tri[:, 0] - v_tri[:, 1]
    v13 = v_tri[:, 1] - v_tri[:, 3]
    nrm = lambda x: np.linalg.norm(x, axis=1)
    aA = nrm(v21) * nrm(v30)
    bB = nrm(v23) * nrm(v10)
    cC = nrm(v20) * nrm(v13)
    V = np.abs((v21 * np.cross(v23, v20, axis=1)).sum(1)) / 6.0
    l = np.min(np.stack([nrm(v21), nrm(v23), nrm(v20), nrm(v30),
                         nrm(v10), nrm(v13)]), axis=0)
    with np.errstate(invalid='ignore', divide='ignore'):
        R = np.sqrt(np.maximum(
            (aA + bB + cC) * (aA + bB - cC) * (aA - bB + cC)
            * (-aA + bB + cC), 0.0)) / np.maximum(24 * V, 1e-30)
        sigma = V / np.maximum(l ** 3, 1e-30)
        rho = R / np.maximum(l, 1e-30)
    return np.flatnonzero((sigma < sigma0) & (rho < rho0))
