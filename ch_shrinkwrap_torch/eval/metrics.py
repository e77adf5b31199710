"""Mesh <-> ground-truth comparison metrics.

Capability parity with the reference ch_shrinkwrap/evaluation_utils.py
(points_from_mesh :35, average_squared_distance :153) and the legacy
suite's ordered-pair Hausdorff metrics
(the reference ch_shrinkwrap/evaluation_utils_old.py:266-463, after
Berger et al., "An End-to-End Framework for Evaluating Surface
Reconstruction", SCI Institute, 2011).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def points_from_mesh(mesh, dx_min: float = 5, p: float = 1.0,
                     return_normals: bool = False, rng=None,
                     sampler: str = 'mc'):
    """Uniform point sampling of a mesh surface at pitch ``dx_min``.

    ``sampler='mc'`` (default) draws the area-weighted uniform sample:
    n = area * p / dx_min^2 points, barycentric-uniform per face — the
    statistical equivalent of the reference rasterizer, and what the
    sweep metrics use.  ``sampler='raster'`` reproduces the
    reference's deterministic per-triangle in-plane lattice
    (evaluation_utils.py:35-151) for committed metric comparisons
    where sampler noise should be zero (only the optional ``p`` < 1
    subsample draws randomness).
    """
    if sampler == 'raster':
        return points_from_mesh_rasterized(
            mesh, dx_min=dx_min, p=p, return_normals=return_normals,
            rng=rng)
    from ..utils.math import _rng
    rng = _rng(rng)

    v = np.asarray(mesh.vertices)
    f = np.asarray(mesh.faces)
    tri = v[f]
    n_vec = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n_vec, axis=1)
    ok = nn > 0
    tri = tri[ok]
    n_vec = n_vec[ok] / nn[ok, None]
    areas = 0.5 * nn[ok]

    total = areas.sum()
    n_samples = max(1, int(round(total * p / (dx_min * dx_min))))
    face_idx = rng.choice(len(areas), size=n_samples, p=areas / total)

    r1 = np.sqrt(rng.uniform(size=n_samples))
    r2 = rng.uniform(size=n_samples)
    a = 1.0 - r1
    b = r1 * (1.0 - r2)
    c = r1 * r2
    pts = (a[:, None] * tri[face_idx, 0] + b[:, None] * tri[face_idx, 1]
           + c[:, None] * tri[face_idx, 2])

    if return_normals:
        return pts, n_vec[face_idx]
    return pts


def points_from_mesh_rasterized(mesh, dx_min: float = 5, p: float = 1.0,
                                return_normals: bool = False, rng=None):
    """Deterministic per-triangle lattice sampling (the reference's
    points_from_mesh, evaluation_utils.py:35-151): each face is
    rasterized on a dx_min-pitch grid in its own plane basis
    (e0 = first edge direction, e1 = n x e0, grid anchored at the
    face's bounding box like the reference), keeping lattice points
    inside the triangle.  Vectorized over blocks of faces instead of
    the reference's per-face Python loop; normals come from the
    generating face directly (the reference re-derives them through a
    nearest-centroid kdtree, which reassigns a point's own face in all
    but degenerate cases)."""
    from ..utils.math import _rng

    v = np.asarray(mesh.vertices, np.float64)
    f = np.asarray(mesh.faces)
    tri = v[f]
    n_vec = np.cross(tri[:, 2] - tri[:, 1], tri[:, 0] - tri[:, 1])
    nn = np.linalg.norm(n_vec, axis=1)
    ok = nn > 0
    tri = tri[ok]
    n_vec = n_vec[ok] / nn[ok, None]

    # per-face plane basis
    v0 = tri[:, 1] - tri[:, 0]
    e0 = v0 / np.maximum(np.linalg.norm(v0, axis=1), 1e-30)[:, None]
    e1 = np.cross(n_vec, e0)

    # 2-D coordinates of the three vertices (relative to vertex 0)
    def uv(k):
        d = tri[:, k] - tri[:, 0]
        return (d * e0).sum(1), (d * e1).sum(1)
    x1, y1 = uv(1)
    x2, y2 = uv(2)

    xl = np.minimum(0, np.minimum(x1, x2))
    xu = np.maximum(0, np.maximum(x1, x2))
    yl = np.minimum(0, np.minimum(y1, y2))
    yu = np.maximum(0, np.maximum(y1, y2))
    # lattice anchored at (xl - dx/2, yl - dx/2) stepping dx, as in
    # the reference's arange(xl - x0 - dx/2, xu - x0, dx)
    nx = np.maximum(np.ceil((xu - xl) / dx_min + 0.5).astype(int), 1)
    ny = np.maximum(np.ceil((yu - yl) / dx_min + 0.5).astype(int), 1)

    out = []
    out_fid = []
    B = 1024
    order = np.argsort(nx * ny, kind='stable')   # similar sizes batch
    for s in range(0, len(tri), B):
        sel = order[s:s + B]
        mx, my = int(nx[sel].max()), int(ny[sel].max())
        gx = np.arange(mx)[None, :]              # (1, mx)
        gy = np.arange(my)[None, :]
        X = xl[sel, None] - dx_min / 2 + dx_min * gx         # (B, mx)
        Y = yl[sel, None] - dx_min / 2 + dx_min * gy
        Xg = X[:, None, :]                       # (B, 1, mx)
        Yg = Y[:, :, None]                       # (B, my, 1)
        gvalid = (gx[:, None, :] < nx[sel][:, None, None]) \
            & (gy[:, :, None] < ny[sel][:, None, None])

        # inside-triangle via the three 2-D edge half-planes of
        # ((0,0), (x1,y1), (x2,y2)) with consistent winding
        def half(ax, ay, bx, by):
            return ((bx - ax)[:, None, None] * (Yg - ay[:, None, None])
                    - (by - ay)[:, None, None] * (Xg - ax[:, None, None]))
        z = np.zeros(len(sel))
        h0 = half(z, z, x1[sel], y1[sel])
        h1 = half(x1[sel], y1[sel], x2[sel], y2[sel])
        h2 = half(x2[sel], y2[sel], z, z)
        wind = np.sign(x1[sel] * y2[sel] - x2[sel] * y1[sel]
                       )[:, None, None]
        inside = (wind * h0 >= 0) & (wind * h1 >= 0) & (wind * h2 >= 0)
        m = inside & gvalid
        bi, yi, xi = np.nonzero(m)
        pts2 = (X[bi, xi][:, None] * e0[sel][bi]
                + Y[bi, yi][:, None] * e1[sel][bi] + tri[sel][bi, 0])
        out.append(pts2)
        out_fid.append(sel[bi])
    d = np.vstack(out)
    fid = np.concatenate(out_fid)

    if p < 1.0:
        rng = _rng(rng)
        keep = rng.choice(len(d), size=int(p * len(d)), replace=False)
        d = d[keep]
        fid = fid[keep]

    if return_normals:
        return d, n_vec[fid]
    return d


def average_squared_distance(points0, points1) -> Tuple[float, float]:
    """Bidirectional nearest-neighbor mean squared distances
    (evaluation_utils.py:153-180)."""
    from scipy.spatial import cKDTree
    t0 = cKDTree(points0)
    t1 = cKDTree(points1)
    e0, _ = t0.query(points1, k=1, workers=-1)
    e1, _ = t1.query(points0, k=1, workers=-1)
    return (float(np.nansum(e0 ** 2) / len(e0)),
            float(np.nansum(e1 ** 2) / len(e1)))


def construct_ordered_pairs(points0, points1, normals0=None, normals1=None):
    """Simplified bidirectional NN correspondences (Phi: 0->1,
    Psi: 1->0).  For the faithful Berger et al. construction with
    normal-line projections and the Fig.-10 special case, use
    :func:`construct_ordered_pairs_berger`."""
    from scipy.spatial import cKDTree
    t0 = cKDTree(points0)
    t1 = cKDTree(points1)
    d01, phi = t1.query(points0, k=1, workers=-1)
    d10, psi = t0.query(points1, k=1, workers=-1)
    return phi, psi, d01, d10


def construct_ordered_pairs_berger(o, m, no, nm, dx_max=1.0, k=10,
                                   special_case=True):
    """Berger et al. ordered correspondences between point sets ``o``
    (omega, ground truth) and ``m`` (mesh samples) with normals
    (section 6 of Berger et al.; reference implementation
    the reference ch_shrinkwrap/evaluation_utils_old.py:266-388).

    A pair is accepted when the nearest neighbor lies close to the
    normal line of the querying point: |n . (q_nn - q)| must exceed the
    NN distance shrunk by the sampling tolerance, dist - dx_max^2 /
    (2 dist).  Points failing the test fall back to scanning their k
    nearest candidates and pairing the first candidate on the normal
    line with ITS nearest partner (the Fig.-10 special case).

    Returns (ox, oa, mx, ma): m[ox] ~ Phi(o[oa]) and o[ma] ~ Psi(m[mx]).
    """
    from scipy.spatial import cKDTree
    o = np.asarray(o, np.float64)
    m = np.asarray(m, np.float64)
    otree = cKDTree(o)
    mtree = cKDTree(m)

    om, oi = otree.query(m, 1, workers=-1)   # nearest o for each m
    mo, mi = mtree.query(o, 1, workers=-1)   # nearest m for each o

    # projection of the NN offset onto the query normal, against the
    # distance shrunk by the sampling tolerance
    mdot = (nm * (o[oi] - m)).sum(1)
    odot = (no * (m[mi] - o)).sum(1)
    m_ok = np.abs(mdot) > om - dx_max * dx_max / (2 * np.maximum(om, 1e-12))
    o_ok = np.abs(odot) > mo - dx_max * dx_max / (2 * np.maximum(mo, 1e-12))

    # accepted direct pairs, deduplicated on the image index
    o_idx = np.flatnonzero(o_ok)
    m_idx = np.flatnonzero(m_ok)
    ox, first = np.unique(mi[o_idx], return_index=True)
    oa = o_idx[first]
    ma, first = np.unique(oi[m_idx], return_index=True)
    mx = m_idx[first]

    if special_case and (len(o_idx) < len(o) or len(m_idx) < len(m)):
        def rescue(fail_pts, fail_nrm, target_tree, target_pts,
                   source_tree):
            """k-NN scan for points failing the direct test: first
            candidate on the normal line, paired with its own nearest
            point in the source set."""
            if len(fail_pts) == 0:
                return (np.zeros(0, np.int64), np.zeros(0, np.int64))
            # clamp k to the target-set size: scipy pads missing
            # neighbors with index n / infinite distance, which would
            # make target_pts[cand] raise on tiny point sets
            kq = min(k, len(target_pts))
            dists, cand = target_tree.query(fail_pts, kq, workers=-1)
            if kq == 1:
                dists = dists[:, None]
                cand = cand[:, None]
            valid = np.isfinite(dists)
            cand = np.clip(cand, 0, len(target_pts) - 1)
            dots = (fail_nrm[:, None, :]
                    * (target_pts[cand] - fail_pts[:, None, :])).sum(2)
            # the reference shrinks by dx^2/(2d + 1e6) here — i.e. the
            # tolerance is effectively disabled for the rescue scan; we
            # reproduce that (quirk kept: it only loosens acceptance)
            ok = valid & (np.abs(dots)
                          > dists - dx_max * dx_max / (2 * dists + 1e6))
            any_ok = ok.any(axis=1)
            chosen = cand[np.arange(len(cand)), np.argmax(ok, axis=1)]
            chosen = chosen[any_ok]
            _, partner = source_tree.query(target_pts[chosen], 1,
                                           workers=-1)
            return chosen, partner

        # o-points without a direct pair -> extra (mx, ma) pairs
        # (chosen candidate in m, its nearest partner in o)
        mx2, ma2 = rescue(o[~o_ok], no[~o_ok], mtree, m, otree)
        # m-points without a direct pair -> extra (ox, oa) pairs
        # (chosen candidate in o, its nearest partner in m)
        oa2_chosen, ox2_partner = rescue(m[~m_ok], nm[~m_ok], otree, o,
                                         mtree)

        # dedup on the PARTNER index, filter on membership of the
        # chosen index in the direct pairs (reference :371-388)
        ma2u, first = np.unique(ma2, return_index=True)
        mx2u = mx2[first]
        ox2u, first = np.unique(ox2_partner, return_index=True)
        oa2u = oa2_chosen[first]

        keep = ~np.isin(mx2u, mx)
        mx = np.hstack([mx, mx2u[keep]])
        ma = np.hstack([ma, ma2u[keep]])
        keep = ~np.isin(oa2u, oa)
        ox = np.hstack([ox, ox2u[keep]])
        oa = np.hstack([oa, oa2u[keep]])

    return ox, oa, mx, ma


def berger_mean_and_hausdorff(o, m, ox, oa, mx, ma):
    """(mean, Hausdorff) over Berger ordered pairs
    (evaluation_utils_old.py:390-397)."""
    dist_o = np.linalg.norm(o[oa] - m[ox], axis=1)
    dist_m = np.linalg.norm(o[ma] - m[mx], axis=1)
    mean = 0.5 * (dist_o.mean() + dist_m.mean())
    hausdorff = max(dist_o.max(), dist_m.max())
    return float(mean), float(hausdorff)


def berger_smoothness(no, nm, ox, oa, mx, ma):
    """Normal-angle (mean, Hausdorff) over Berger ordered pairs
    (evaluation_utils_old.py:399-406).  Signed dot, as in the
    reference: antiparallel normals read as angle ~pi (an orientation
    flip), not as smooth.  We add only the arccos domain clip."""
    a_o = np.arccos(np.clip((no[oa] * nm[ox]).sum(1), -1, 1))
    a_m = np.arccos(np.clip((no[ma] * nm[mx]).sum(1), -1, 1))
    return (float(0.5 * (a_o.mean() + a_m.mean())),
            float(max(a_o.max(), a_m.max())))


def mean_and_hausdorff_distance(points0, points1):
    """(mean distance, Hausdorff distance) over bidirectional NN pairs
    (evaluation_utils_old.py:390-397)."""
    _, _, d01, d10 = construct_ordered_pairs(points0, points1)
    mean = 0.5 * (d01.mean() + d10.mean())
    hausdorff = max(d01.max(), d10.max())
    return float(mean), float(hausdorff)


def hausdorff_smoothness(points0, points1, normals0, normals1):
    """Normal-angle mean / Hausdorff over NN correspondences
    (evaluation_utils_old.py:399-406).

    DELIBERATE DEVIATION: the reference uses the signed dot; this
    lighter panel takes ``abs`` so the metric is orientation-invariant
    (mesh-vs-SDF normal orientations are not aligned here).  The
    faithful signed construction is ``berger_smoothness``."""
    phi, psi, _, _ = construct_ordered_pairs(points0, points1)

    def angles(na, nb):
        d = np.clip(np.abs((na * nb).sum(1)), -1.0, 1.0)
        return np.arccos(d)

    a01 = angles(normals0, normals1[phi])
    a10 = angles(normals1, normals0[psi])
    return (0.5 * (a01.mean() + a10.mean()),
            max(a01.max(), a10.max()))


def mesh_metrics_vs_shape(mesh, shape, dx_min=5.0, p=1.0, rng=None):
    """Full metric panel of a fitted mesh against an SDF shape oracle."""
    pts, nrm = points_from_mesh(mesh, dx_min=dx_min, p=p,
                                return_normals=True, rng=rng)
    sdf_d = shape.sdf(pts.T)
    out = {
        'sdf_rms': float(np.sqrt((sdf_d ** 2).mean())),
        'sdf_mean_abs': float(np.abs(sdf_d).mean()),
        'sdf_hausdorff': float(np.abs(sdf_d).max()),
        # the max is a single-sample tail (one deep pocket dominates on
        # composite shapes, e.g. ERSim 167 vs Berger-H 22.6 nm); p99
        # separates a systematic miss from a sampling artifact
        'sdf_p99': float(np.percentile(np.abs(sdf_d), 99.0)),
    }
    return out


def compute_mesh_metrics(mesh, truth_points, truth_normals=None,
                         dx_min=5.0, p=1.0, rng=None):
    """Aggregate metric panel of a fitted mesh vs a ground-truth cloud
    (counterpart of the legacy suite's compute_mesh_metrics,
    evaluation_utils_old.py:738-801)."""
    pts, nrm = points_from_mesh(mesh, dx_min=dx_min, p=p,
                                return_normals=True, rng=rng)
    mse01, mse10 = average_squared_distance(truth_points, pts)
    mean_d, hausdorff = mean_and_hausdorff_distance(pts, truth_points)
    out = {
        'mse01': mse01,
        'mse10': mse10,
        'mse_rms': float(np.sqrt((mse01 + mse10) / 2)),
        'mean_distance': mean_d,
        'hausdorff_distance': hausdorff,
        'ntriangles': int(mesh.faces.shape[0]),
        'nvertices': int(mesh.vertices.shape[0]),
        'euler': int(mesh.euler_characteristic),
        'genus': float(mesh.genus),
        'manifold': bool(mesh.is_manifold),
        'components': int(mesh.connected_components()[1]),
        'area': float(mesh.area()),
        'volume': float(mesh.volume()),
    }
    if truth_normals is not None:
        smooth_mean, smooth_haus = hausdorff_smoothness(
            pts, truth_points, nrm, truth_normals)
        out['smoothness_mean'] = float(smooth_mean)
        out['smoothness_hausdorff'] = float(smooth_haus)
        # faithful Berger ordered-pair versions of the same metrics
        try:
            ox, oa, mx, ma = construct_ordered_pairs_berger(
                truth_points, pts, truth_normals, nrm, dx_max=dx_min)
            bm, bh = berger_mean_and_hausdorff(truth_points, pts,
                                               ox, oa, mx, ma)
            out['berger_mean_distance'] = bm
            out['berger_hausdorff'] = bh
            sm, sh = berger_smoothness(truth_normals, nrm, ox, oa, mx, ma)
            out['berger_smoothness_mean'] = sm
            out['berger_smoothness_hausdorff'] = sh
        except Exception:
            pass
    return out
