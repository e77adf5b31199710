"""Batched isotropic remeshing over compact (V, F) arrays.

Counterpart of PYME ``TriangleMesh.remesh`` (edge split / collapse /
flip / tangential relax), which the reference drives on an edge-length
schedule (_membrane_mesh.pyx:1443-1455, 1546).  Re-designed as
conflict-free vectorized batch passes instead of in-place halfedge
surgery: every pass computes an edit mask over unique undirected edges,
selects a maximal independent set with a vectorized min-rank rule, and
emits a fresh (V, F) pair.  This is the "masked batched topology pass"
architecture the device pipeline needs — between passes the mesh is
always a compact, pad-able triangle soup.

Thresholds follow the classic Botsch-Kobbelt recipe: split edges longer
than 4/3 of the target length, collapse edges shorter than 4/5 of it.
"""

from __future__ import annotations

import numpy as np

from ..utils import tracing


def unique_edges(faces: np.ndarray):
    """Unique undirected edges of (F, 3) faces.

    Returns
    -------
    edges : (E, 2) int64, each row sorted lo < hi
    edge_of_slot : (F, 3) int64, unique-edge id of face f's k-th edge
        (the edge between ``faces[f, k]`` and ``faces[f, (k+1) % 3]``).
    """
    a = faces
    b = faces[:, [1, 2, 0]]
    lo = np.minimum(a, b).ravel()
    hi = np.maximum(a, b).ravel()
    key = lo.astype(np.int64) << 32 | hi.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    edges = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1)
    return edges, inv.reshape(faces.shape)


def edge_lengths(vertices, edges):
    d = vertices[edges[:, 0]] - vertices[edges[:, 1]]
    return np.sqrt((d * d).sum(1))


def split_pass(vertices, faces, threshold):
    """Split every edge longer than ``threshold`` at its midpoint.

    Conflict-free: each face is independently re-triangulated by its
    3-bit split pattern, midpoints are shared through unique-edge ids.
    """
    if faces.size == 0:
        return vertices, faces, 0
    edges, slot = unique_edges(faces)
    lengths = edge_lengths(vertices, edges)
    split = lengths > threshold
    n_split = int(split.sum())
    if n_split == 0:
        return vertices, faces, 0
    midpoints = 0.5 * (vertices[edges[split, 0]] + vertices[edges[split, 1]])
    return _apply_edge_splits(vertices, faces, slot, split, midpoints)


def _apply_edge_splits(vertices, faces, slot, split, split_points):
    """Re-triangulate every face by its 3-bit split pattern, inserting
    ``split_points`` (one row per True in ``split``) on the split edges."""
    n_split = int(split.sum())
    V = vertices.shape[0]
    mid_id = np.full(len(split), -1, np.int64)
    mid_id[split] = V + np.arange(n_split)
    new_vertices = np.vstack([vertices, split_points.astype(np.float32)])

    m = mid_id[slot]                  # (F, 3) midpoint ids or -1
    bits = ((m[:, 0] >= 0).astype(np.int8)
            + 2 * (m[:, 1] >= 0).astype(np.int8)
            + 4 * (m[:, 2] >= 0).astype(np.int8))

    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    m01, m12, m20 = m[:, 0], m[:, 1], m[:, 2]
    out = []

    def emit(mask, *tris):
        if not mask.any():
            return
        for (a, b, c) in tris:
            out.append(np.stack([a[mask], b[mask], c[mask]], axis=1))

    emit(bits == 0, (v0, v1, v2))
    emit(bits == 1, (v0, m01, v2), (m01, v1, v2))
    emit(bits == 2, (v1, m12, v0), (m12, v2, v0))
    emit(bits == 4, (v2, m20, v1), (m20, v0, v1))
    emit(bits == 3, (m01, v1, m12), (v0, m01, m12), (v0, m12, v2))
    emit(bits == 6, (m12, v2, m20), (v1, m12, m20), (v1, m20, v0))
    emit(bits == 5, (m20, v0, m01), (v2, m20, m01), (v2, m01, v1))
    emit(bits == 7, (v0, m01, m20), (m01, v1, m12), (m20, m12, v2),
         (m01, m12, m20))

    new_faces = np.vstack(out).astype(np.int32)
    return new_vertices, new_faces, n_split


def skeleton_split_pass(vertices, faces, max_triangle_angle=1.9198622):
    """Angle-driven projection split (the skeleton remesher's split,
    ch_shrinkwrap/_skeleton_mesh.pyx:29-332, as a batch
    pass): an interior edge whose BOTH opposite angles exceed
    ``max_triangle_angle`` is split at the perpendicular projection of
    the larger-angle apex onto the edge (not the midpoint — MCF
    contraction makes triangles arbitrarily obtuse, and the projection
    point is what restores their aspect).
    """
    if faces.size == 0:
        return vertices, faces, 0
    edges, slot = unique_edges(faces)
    lengths = edge_lengths(vertices, edges)

    # angle opposite each face-edge occurrence: edge k of face f runs
    # faces[f,k] -> faces[f,(k+1)%3], apex is faces[f,(k+2)%3]
    p0 = vertices[faces]                       # (F, 3, 3)
    apex = np.roll(faces, -2, axis=1)          # (F, 3) apex of edge k
    a = p0 - vertices[apex]                    # apex -> faces[f,k]
    b = vertices[np.roll(faces, -1, axis=1)] - vertices[apex]
    num = (a * b).sum(2)
    den = np.sqrt((a * a).sum(2) * (b * b).sum(2))
    cosang = np.where(den > 0, num / np.maximum(den, 1e-30), 1.0)
    ang = np.arccos(np.clip(cosang, -1.0, 1.0))  # (F, 3)

    E = len(edges)
    flat_slot = slot.ravel()
    flat_ang = ang.ravel()
    min_ang = np.full(E, np.inf)
    max_ang = np.full(E, -np.inf)
    np.minimum.at(min_ang, flat_slot, flat_ang)
    np.maximum.at(max_ang, flat_slot, flat_ang)
    n_incident = np.bincount(flat_slot, minlength=E)

    split = ((n_incident == 2) & (min_ang > max_triangle_angle)
             & (lengths > 1e-6))
    n_split = int(split.sum())
    if n_split == 0:
        return vertices, faces, 0

    # apex of the larger-angle side per edge (first max occurrence)
    order = np.lexsort((-flat_ang, flat_slot))
    first = np.zeros(E, np.int64)
    s_sorted = flat_slot[order]
    _, idx0 = np.unique(s_sorted, return_index=True)
    first[s_sorted[idx0]] = order[idx0]
    apex_v = apex.ravel()[first[split]]

    u = vertices[edges[split, 0]].astype(np.float64)
    w = vertices[edges[split, 1]].astype(np.float64)
    t = (((vertices[apex_v] - u) * (w - u)).sum(1)
         / np.maximum(((w - u) ** 2).sum(1), 1e-30))
    # an obtuse apex angle puts the foot strictly inside the edge; the
    # clip only guards degenerate float cases
    t = np.clip(t, 0.05, 0.95)[:, None]
    pts = u + t * (w - u)
    return _apply_edge_splits(vertices, faces, slot, split, pts)


def _independent_edge_set(edges, priority, n_vertices):
    """Select edges such that no vertex appears twice, preferring low
    ``priority``; vectorized min-rank rule (each selected edge is the
    best-ranked candidate at both endpoints)."""
    order = np.argsort(priority, kind='stable')
    rank = np.empty(len(edges), np.int64)
    rank[order] = np.arange(len(edges))
    best = np.full(n_vertices, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(best, edges[:, 0], rank)
    np.minimum.at(best, edges[:, 1], rank)
    return (best[edges[:, 0]] == rank) & (best[edges[:, 1]] == rank)


def collapse_pass(vertices, faces, threshold, neighbor_cap=20,
                  protect=None, veto_cos=None, veto_min_len=0.0):
    """Collapse edges shorter than ``threshold`` to their midpoints.

    Guards (counterparts of the reference's manifold checks,
    _skeleton_mesh.pyx:334-499): link condition (the endpoints' shared
    one-ring must be exactly the opposite vertices of the shared faces),
    valence cap, boundary exclusion, and a vectorized independent set so
    no vertex takes part in two collapses per pass.

    ``veto_cos`` (opt-in thin-tube pinch protection, numpy twin of the
    native veto): skip candidates whose endpoint-normal dot falls
    below it while the edge is longer than ``veto_min_len``.
    """
    if faces.size == 0:
        return vertices, faces, 0
    edges, slot = unique_edges(faces)
    lengths = edge_lengths(vertices, edges)

    # edge -> number of incident faces (1 = boundary, >2 = non-manifold)
    n_incident = np.bincount(slot.ravel(), minlength=len(edges))

    cand = (lengths < threshold) & (n_incident == 2)
    if protect is not None:
        cand &= ~(protect[edges[:, 0]] | protect[edges[:, 1]])
    if veto_cos is not None and cand.any():
        fn = np.cross(vertices[faces[:, 1]] - vertices[faces[:, 0]],
                      vertices[faces[:, 2]] - vertices[faces[:, 0]])
        vn = np.zeros_like(vertices)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        na, nb2 = vn[edges[:, 0]], vn[edges[:, 1]]
        dp = (na * nb2).sum(1)
        nn = (np.linalg.norm(na, axis=1) * np.linalg.norm(nb2, axis=1)
              + 1e-30)
        cand &= ~((dp < veto_cos * nn) & (lengths > veto_min_len))
    if not cand.any():
        return vertices, faces, 0

    V = vertices.shape[0]
    # boundary vertices (touch an edge with != 2 incident faces)
    boundary_v = np.zeros(V, dtype=bool)
    nb = n_incident != 2
    boundary_v[edges[nb, 0]] = True
    boundary_v[edges[nb, 1]] = True
    cand &= ~(boundary_v[edges[:, 0]] | boundary_v[edges[:, 1]])
    if not cand.any():
        return vertices, faces, 0

    # neighbor table for link condition + valence
    nbrs, valence = _neighbor_table(faces, V, cap=neighbor_cap + 12)
    cand &= (valence[edges[:, 0]] + valence[edges[:, 1]] - 4) <= neighbor_cap
    idx = np.flatnonzero(cand)
    if len(idx) == 0:
        return vertices, faces, 0

    # link condition: |N(a) & N(b)| must be exactly 2
    na = nbrs[edges[idx, 0]]          # (C, K)
    nb_ = nbrs[edges[idx, 1]]
    common = ((na[:, :, None] == nb_[:, None, :]) & (na[:, :, None] >= 0)
              ).sum(axis=(1, 2))
    idx = idx[common == 2]
    if len(idx) == 0:
        return vertices, faces, 0

    # Distance-1 independence: two collapse edges may not share or be
    # adjacent to each other's endpoints (two individually link-safe
    # collapses at adjacent edges can jointly create duplicate faces /
    # non-manifold edges through a shared neighbor quad).  Each
    # candidate stamps its rank onto {a, b} + N(a) + N(b) and is
    # selected iff it holds the minimum at both of its own endpoints.
    cand_idx = idx
    order = np.argsort(lengths[cand_idx], kind='stable')
    rank = np.empty(len(cand_idx), np.int64)
    rank[order] = np.arange(len(cand_idx))
    claims = np.concatenate([
        edges[cand_idx, 0:1], edges[cand_idx, 1:2],
        nbrs[edges[cand_idx, 0]], nbrs[edges[cand_idx, 1]]], axis=1)
    claim_v = np.where(claims >= 0, claims, edges[cand_idx, 0:1])
    best = np.full(V, np.iinfo(np.int64).max, np.int64)
    for col in range(claim_v.shape[1]):
        np.minimum.at(best, claim_v[:, col], rank)
    win = ((best[edges[cand_idx, 0]] == rank)
           & (best[edges[cand_idx, 1]] == rank))
    sel = np.zeros(len(edges), dtype=bool)
    sel[cand_idx[win]] = True
    if not sel.any():
        return vertices, faces, 0

    a = edges[sel, 0]
    b = edges[sel, 1]
    new_vertices = vertices.copy()
    new_vertices[a] = 0.5 * (vertices[a] + vertices[b])

    remap = np.arange(V, dtype=np.int64)
    remap[b] = a
    new_faces = remap[faces]
    degen = ((new_faces[:, 0] == new_faces[:, 1])
             | (new_faces[:, 1] == new_faces[:, 2])
             | (new_faces[:, 0] == new_faces[:, 2]))
    new_faces = new_faces[~degen].astype(np.int32)
    return new_vertices.astype(np.float32), new_faces, int(sel.sum())


def flip_pass(vertices, faces):
    """Flip interior edges to drive vertex valences toward 6.

    An edge flips when it strictly reduces the summed squared valence
    deviation of the four quad vertices, the opposite edge does not
    already exist, and the flipped triangles stay consistently oriented.
    Independent set: no two flips share a face.
    """
    if faces.size == 0:
        return vertices, faces, 0
    V = vertices.shape[0]
    edges, slot = unique_edges(faces)
    E = len(edges)

    # faces on each side of each unique edge
    face_of = np.repeat(np.arange(faces.shape[0]), 3)
    eid = slot.ravel()
    order = np.argsort(eid, kind='stable')
    eid_s = eid[order]
    face_s = face_of[order]
    k_s = (order % 3)
    starts = np.searchsorted(eid_s, np.arange(E))
    counts = np.bincount(eid_s, minlength=E)
    interior = counts == 2
    f1 = np.where(interior, face_s[np.clip(starts, 0, len(face_s) - 1)], -1)
    k1 = np.where(interior, k_s[np.clip(starts, 0, len(face_s) - 1)], 0)
    f2 = np.where(interior, face_s[np.clip(starts + 1, 0, len(face_s) - 1)], -1)
    k2 = np.where(interior, k_s[np.clip(starts + 1, 0, len(face_s) - 1)], 0)

    valence = np.bincount(faces.ravel(), minlength=V).astype(np.int64)

    # quad vertices: edge (a -> b) in face1's winding; c opposite in f1,
    # d opposite in f2
    a = faces[np.clip(f1, 0, None), k1]
    b = faces[np.clip(f1, 0, None), (k1 + 1) % 3]
    c = faces[np.clip(f1, 0, None), (k1 + 2) % 3]
    d = faces[np.clip(f2, 0, None), (k2 + 2) % 3]

    dev = lambda v: (valence[v] - 6) ** 2
    before = dev(a) + dev(b) + dev(c) + dev(d)
    after = ((valence[a] - 7) ** 2 + (valence[b] - 7) ** 2
             + (valence[c] - 5) ** 2 + (valence[d] - 5) ** 2)
    want = interior & (after < before) & (c != d)

    # geometric guard: flipped triangles (a,d,c), (d,b,c) must keep the
    # orientation of the original pair (no fold-over)
    if want.any():
        pa, pb, pc, pd = (vertices[v] for v in (a, b, c, d))
        n_old = np.cross(pb - pa, pc - pa)
        n1 = np.cross(pd - pa, pc - pd)
        n2 = np.cross(pb - pd, pc - pb)
        ok = ((n1 * n_old).sum(1) > 1e-12) & ((n2 * n_old).sum(1) > 1e-12)
        want &= ok

    # opposite edge must not already exist
    if want.any():
        key = (np.minimum(c, d).astype(np.int64) << 32
               | np.maximum(c, d).astype(np.int64))
        ekey = edges[:, 0] << 32 | edges[:, 1]
        exists = np.isin(key, ekey)
        want &= ~exists

    if not want.any():
        return vertices, faces, 0

    # independent set over the whole quad (no two flips share a face OR
    # a quad vertex — valence deltas of concurrent flips would interact)
    idx = np.flatnonzero(want)
    rank = np.argsort(np.argsort(-(before - after)[idx]))
    fbest = np.full(faces.shape[0], np.iinfo(np.int64).max, np.int64)
    np.minimum.at(fbest, f1[idx], rank)
    np.minimum.at(fbest, f2[idx], rank)
    vbest = np.full(V, np.iinfo(np.int64).max, np.int64)
    for vv in (a, b, c, d):
        np.minimum.at(vbest, vv[idx], rank)
    keep = (fbest[f1[idx]] == rank) & (fbest[f2[idx]] == rank)
    for vv in (a, b, c, d):
        keep &= vbest[vv[idx]] == rank
    idx = idx[keep]
    if len(idx) == 0:
        return vertices, faces, 0

    new_faces = faces.copy()
    new_faces[f1[idx]] = np.stack([a[idx], d[idx], c[idx]], axis=1)
    new_faces[f2[idx]] = np.stack([d[idx], b[idx], c[idx]], axis=1)
    return vertices, new_faces, len(idx)


def relax_pass(vertices, faces, l=0.5, n_iter=1):
    """Tangential smoothing: move vertices toward the area-weighted
    centroid of their one-ring, projected into the tangent plane."""
    if n_iter <= 0 or faces.size == 0:
        return vertices
    v = vertices.astype(np.float64)
    for _ in range(n_iter):
        tri = v[faces]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        areas = 0.5 * np.linalg.norm(fn, axis=1)
        centroids = tri.mean(1)

        acc = np.zeros_like(v)
        wsum = np.zeros(v.shape[0])
        for k in range(3):
            np.add.at(acc, faces[:, k], centroids * areas[:, None])
            np.add.at(wsum, faces[:, k], areas)
        target = acc / np.maximum(wsum, 1e-12)[:, None]

        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, faces[:, k], fn)
        nn = np.linalg.norm(vn, axis=1)
        vn = vn / np.maximum(nn, 1e-12)[:, None]

        delta = target - v
        delta = delta - vn * (delta * vn).sum(1)[:, None]
        v = v + l * delta
    return v.astype(np.float32)


def _neighbor_table(faces, n_vertices, cap=32):
    """(V, cap) neighbor-vertex table + valence, -1 padded."""
    src = faces.ravel()
    dst = faces[:, [1, 2, 0]].ravel()
    order = np.argsort(src, kind='stable')
    ssrc = src[order]
    starts = np.searchsorted(ssrc, np.arange(n_vertices))
    rank = np.arange(len(ssrc)) - starts[ssrc]
    tbl = np.full((n_vertices, cap), -1, np.int64)
    ok = rank < cap
    tbl[ssrc[ok], rank[ok]] = dst[order[ok]]
    valence = np.bincount(src, minlength=n_vertices).astype(np.int64)
    return tbl, valence


def compact(vertices, faces, extra=None):
    """Drop unreferenced vertices, remapping faces (and extra arrays)."""
    used = np.unique(faces.ravel()) if faces.size else np.zeros(0, np.int64)
    remap = np.full(vertices.shape[0], -1, np.int64)
    remap[used] = np.arange(len(used))
    new_faces = remap[faces].astype(np.int32)
    if extra is not None:
        return vertices[used], new_faces, {k: v[used] for k, v in extra.items()}
    return vertices[used], new_faces


def remesh(mesh, n=5, target_edge_length=-1.0, l=0.5, n_relax=10,
           use_native=True, collapse_veto_cos=None,
           collapse_veto_min_frac=0.25):
    """Isotropic remesh toward ``target_edge_length``.

    Parameters mirror the reference call signature
    (``TriangleMesh.remesh(n, target_edge_length, l, n_relax)``,
    _membrane_mesh.pyx:249): ``n`` outer passes, ``l`` the relax step.
    ``use_native`` runs the C++ engine (``native.remesh``, sequential
    guarded greedy passes), which raises when it cannot be built.
    ``use_native=False`` runs the vectorized numpy batch passes below:
    another algorithm (independent sets of candidates a batch), so
    another mesh; the tests' cross-validation reference, never a
    fallback.
    """
    v, f = mesh.vertices, mesh.faces
    if target_edge_length <= 0:
        # halfedge-mean == unique-edge mean on closed meshes (each
        # interior edge counted twice); avoids a full key sort here
        target_edge_length = float(mesh._mean_edge_length)

    if use_native:
        from .. import native
        with tracing.span(mesh, 'engine') as rec:
            out = native.remesh(v, f, float(target_edge_length), n_passes=n,
                                l=l, n_relax=n_relax,
                                veto_cos=collapse_veto_cos,
                                veto_min_len=(collapse_veto_min_frac
                                              * float(target_edge_length)))
            if rec is not None:
                rec.extra.update(out[2])
        with tracing.span(mesh, 'topology'):
            mesh.set_topology(out[0], out[1])
        # collapse can shrink split-off fragments below a closed
        # surface's 4-face minimum (degenerate pillows)
        with tracing.span(mesh, 'components'):
            mesh.remove_degenerate_components()
        return mesh

    high = 4.0 / 3.0 * target_edge_length
    low = 4.0 / 5.0 * target_edge_length

    for _ in range(n):
        v, f, _ns = split_pass(v, f, high)
        # independent-set collapses only touch a fraction of the
        # candidates per batch; iterate to approach the fixpoint
        for _ in range(16):
            v, f, nc = collapse_pass(
                v, f, low, veto_cos=collapse_veto_cos,
                veto_min_len=collapse_veto_min_frac
                * float(target_edge_length))
            v, f = compact(v, f)
            if nc == 0:
                break
            v, f, _ = flip_pass(v, f)
        v, f, _nf = flip_pass(v, f)
        v = relax_pass(v, f, l=l, n_iter=n_relax)

    mesh.set_topology(v, f)
    mesh.remove_degenerate_components()
    return mesh
