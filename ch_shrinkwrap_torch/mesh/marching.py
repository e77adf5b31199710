"""Implicit-surface extraction: vectorized marching tetrahedra.

Replaces the PYME ``func_octree`` + ``dual_marching_cubes`` pipeline the
reference uses for initial surfaces (`wrap_start`,
ch_shrinkwrap/holepunch.py:88-112) and for the
evaluation chain's Octree->DualMarchingCubes seed
(ch_shrinkwrap/evaluation.py:61-113).  A uniform grid
with the Freudenthal/Kuhn 6-tetrahedron cube decomposition is
consistent across cube faces (watertight output) and needs no case
table — each tetrahedron has only 4 sign patterns, all emitted as
vectorized numpy batches.
"""

from __future__ import annotations

import numpy as np

from ..utils.tracing import FitTrace

# Freudenthal/Kuhn decomposition: the 6 tets are the 6 axis-orderings
# of the path from corner 0 (0,0,0) to corner 7 (1,1,1); corner id is
# bit-coded dx + 2 dy + 4 dz.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
    [0, 5, 1, 7],
], dtype=np.int64)


def marching_tetrahedra(values: np.ndarray, origin, spacing):
    """Extract the zero level set of a scalar grid.

    Parameters
    ----------
    values : (nx, ny, nz) float — sampled implicit function (negative
        inside, positive outside).
    origin : (3,) — position of grid node (0, 0, 0).
    spacing : float or (3,) — grid step.

    Returns
    -------
    vertices : (V, 3) float32 (welded), faces : (F, 3) int32 with
        normals pointing toward positive values.
    """
    values = np.asarray(values, dtype=np.float64)
    # symbolic perturbation: an exact zero at a grid node would emit the
    # same geometric vertex under several different edge keys (cracks);
    # nudge zeros off the level set instead.
    scale = np.max(np.abs(values)) or 1.0
    values = np.where(values == 0.0, 1e-9 * scale, values)
    nx, ny, nz = values.shape
    origin = np.asarray(origin, dtype=np.float64)
    spacing = np.broadcast_to(np.asarray(spacing, dtype=np.float64), (3,))

    def gid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing='ij')
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    corner_ids = np.stack([gid(ix + (c & 1), iy + ((c >> 1) & 1),
                               iz + ((c >> 2) & 1))
                           for c in range(8)], axis=1)    # (C, 8)

    tets = corner_ids[:, _TETS].reshape(-1, 4)            # (6C, 4)
    flat_vals = values.ravel()
    tv = flat_vals[tets]                                  # (6C, 4)

    inside = tv < 0
    count = inside.sum(1)
    active = (count > 0) & (count < 4)
    tets = tets[active]
    tv = tv[active]
    inside = inside[active]
    count = count[active]
    if len(tets) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    # permute corners: inside first (stable)
    perm = np.argsort(~inside, axis=1, kind='stable')
    tets_p = np.take_along_axis(tets, perm, axis=1)
    a, b, c, d = tets_p.T

    def edge(u, v):
        """Global undirected edge key for grid nodes u, v."""
        lo = np.minimum(u, v)
        hi = np.maximum(u, v)
        return lo.astype(np.int64) * (nx * ny * nz) + hi

    tris_e = []   # list of (n, 3) edge-key triangles

    m1 = count == 1     # inside: a  -> tri (ab, ac, ad)
    if m1.any():
        tris_e.append(np.stack([edge(a[m1], b[m1]), edge(a[m1], c[m1]),
                                edge(a[m1], d[m1])], axis=1))
    m2 = count == 2     # inside: a, b -> quad (ac, ad, bd, bc)
    if m2.any():
        ac, ad = edge(a[m2], c[m2]), edge(a[m2], d[m2])
        bd, bc = edge(b[m2], d[m2]), edge(b[m2], c[m2])
        tris_e.append(np.stack([ac, ad, bd], axis=1))
        tris_e.append(np.stack([ac, bd, bc], axis=1))
    m3 = count == 3     # inside: a, b, c -> tri (ad, bd, cd)
    if m3.any():
        tris_e.append(np.stack([edge(a[m3], d[m3]), edge(b[m3], d[m3]),
                                edge(c[m3], d[m3])], axis=1))
    tri_edges = np.vstack(tris_e)

    # weld: unique crossing edges become mesh vertices
    uniq, inv = np.unique(tri_edges.ravel(), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)

    lo = uniq // (nx * ny * nz)
    hi = uniq % (nx * ny * nz)

    def node_pos(g):
        izc = g % nz
        iyc = (g // nz) % ny
        ixc = g // (ny * nz)
        return origin[None, :] + np.stack([ixc, iyc, izc], axis=1) * spacing

    p_lo = node_pos(lo)
    p_hi = node_pos(hi)
    v_lo = flat_vals[lo]
    v_hi = flat_vals[hi]
    t = v_lo / np.where(np.abs(v_lo - v_hi) < 1e-30, 1e-30, v_lo - v_hi)
    t = np.clip(t, 0.0, 1.0)
    vertices = (p_lo + t[:, None] * (p_hi - p_lo)).astype(np.float32)

    # orient: normal should point toward positive values (outside);
    # outward direction ~ (mean outside corner) - (mean inside corner)
    tpos = node_pos(tets_p.ravel()).reshape(-1, 4, 3)
    n_in = count
    csum = tpos.cumsum(axis=1)
    mean_in = csum[np.arange(len(n_in)), n_in - 1] / n_in[:, None]
    mean_out = (csum[:, 3] - csum[np.arange(len(n_in)), n_in - 1]) \
        / (4 - n_in)[:, None]
    outward = mean_out - mean_in

    # expand per-triangle outward dirs matching tris_e emission order
    out_dirs = []
    if m1.any():
        out_dirs.append(outward[m1])
    if m2.any():
        out_dirs.append(outward[m2])
        out_dirs.append(outward[m2])
    if m3.any():
        out_dirs.append(outward[m3])
    out_dirs = np.vstack(out_dirs)

    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (n * out_dirs).sum(1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # secondary position weld: grid nodes lying (near-)exactly on the
    # level set spawn one crossing vertex per incident edge; merge
    # coincident vertices and drop the resulting sliver triangles.
    tol = float(np.min(spacing)) * 1e-4
    pkey = np.round(vertices / tol).astype(np.int64)
    uniq_p, inv_p = np.unique(pkey, axis=0, return_inverse=True)
    first = np.full(len(uniq_p), len(vertices), np.int64)
    np.minimum.at(first, inv_p, np.arange(len(vertices)))
    vertices = vertices[first]
    faces = inv_p[faces].astype(np.int32)

    degen = ((faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2])
             | (faces[:, 0] == faces[:, 2]))
    return vertices, faces[~degen]


def surface_from_function(f, bbox, step):
    """Mesh the zero level set of ``f`` over bbox at grid pitch ``step``.

    f : callable taking (N, 3) -> (N,) signed values.
    bbox : (x0, y0, z0, x1, y1, z1).
    """
    x0, y0, z0, x1, y1, z1 = bbox
    xs = np.arange(x0, x1 + step, step)
    ys = np.arange(y0, y1 + step, step)
    zs = np.arange(z0, z1 + step, step)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing='ij')
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    vals = np.asarray(f(pts)).reshape(X.shape)
    return marching_tetrahedra(vals, (x0, y0, z0), step)


def wrap_start(points, offset=10.0, neighbourhood=50, grid_n=48,
               max_tree_points=None):
    """kNN-density initial wrap surface (holepunch.py:88-112 rebuild):
    the level set of (distance to the ``neighbourhood``-th nearest
    localization) - offset, meshed and remeshed.

    The field query is distance-bounded: the k-th-NN distance is
    1-Lipschitz and marching only ever interpolates along edges that
    CROSS the level set, whose far endpoints lie within one tet edge
    (at most the sqrt(3)*step cube body diagonal) of it — so values
    beyond offset + 1.8*step can be clamped without changing a single
    output vertex, and the bound prunes the hollow interior, the
    kd-tree's worst case (31.9 -> 10.4 s at 1e6 points round 2).

    The field itself runs on the native grid-bucketed engine
    (``native.knn_field``: counting-sorted cells + chessboard distance
    transform for O(1) interior rejection + expanding-ring exact
    search), 25x faster than a scipy kd-tree on this workload.

    ``max_tree_points`` optionally subsamples the cloud with
    ``neighbourhood`` thinned proportionally (k-th NN radius of a
    p-thinned process with k' = p*k estimates the same density
    isosurface). 200k/1e6 is ~3.5x faster again BUT measurably noisier
    (seed-surface radial std 0.9 vs 0.5 nm on the benchmark sphere,
    and the downstream 20-iter fit converged 6 nm worse) — hence
    opt-in, not default.

    The returned mesh carries the ``FitTrace`` of its ``seed`` span
    (``mesh.trace``), which a ``MembraneMesh`` built from it continues."""
    from .core import TriangleMesh
    from .remesh import remesh
    from .. import native

    trace = FitTrace()
    with trace.span('seed'):
        points = np.asarray(points)
        if max_tree_points is not None and len(points) > max_tree_points:
            frac = max_tree_points / len(points)
            k_eff = max(3, int(round(neighbourhood * frac)))
            sel = np.random.default_rng(0).choice(len(points),
                                                  max_tree_points,
                                                  replace=False)
            field_pts = points[sel]
        else:
            k_eff = neighbourhood
            field_pts = points

        lo = points.min(0) - 2 * offset
        hi = points.max(0) + 2 * offset
        step = float((hi - lo).max()) / grid_n

        # crossing-edge endpoints satisfy d_k < offset + sqrt(3)*step
        # (1-Lipschitz field, body-diagonal tet edges); 1.8 adds margin
        bound = offset + 1.8 * step

        def f(p):
            with trace.span('field'):
                d = native.knn_field(field_pts, p, k_eff, bound)
            return np.where(d <= bound, d, bound) - offset

        with trace.span('march'):
            v, fc = surface_from_function(f, (lo[0], lo[1], lo[2],
                                              hi[0], hi[1], hi[2]), step)
        with trace.span('clean'):
            mesh = TriangleMesh(v, fc)
            mesh.repair()
            mesh.remove_inner_surfaces()
        # the fit that starts from this surface continues its trace
        mesh.trace = trace
        with trace.span('remesh'):
            remesh(mesh, n=3, target_edge_length=step * 0.7, n_relax=2)
    return mesh


def initial_surface_from_density(points, threshold_density=None,
                                 n_points_min=50, grid_n=48):
    """Density-thresholded initial surface — the counterpart of the
    evaluation chain's Octree -> DualMarchingCubes seed
    (evaluation.py:61-113): surface where the local kNN density
    estimate crosses ``threshold_density`` (points / nm^3)."""
    from scipy.spatial import cKDTree

    points = np.asarray(points)
    k = max(int(n_points_min), 4)
    if threshold_density is None:
        # default: half the median density of the cloud
        tree = cKDTree(points)
        dd, _ = tree.query(points[::max(1, len(points) // 1000)], k=k,
                           workers=-1)
        r = dd[:, -1]
        threshold_density = float(np.median(
            k / ((4.0 / 3.0) * np.pi * r ** 3))) / 2.0
    # density = threshold  <=>  r_k = (3 k / (4 pi rho))^(1/3)
    r_thresh = (3.0 * k / (4.0 * np.pi * threshold_density)) ** (1.0 / 3.0)
    return wrap_start(points, offset=r_thresh, neighbourhood=k,
                      grid_n=grid_n)
