"""Plain checks of a surface the host surgery hands on.

``defects`` counts what breaks a closed, consistently oriented
triangle surface: a face index outside the vertex table, a face that
repeats a vertex, a directed edge used twice (a fold or a non-manifold
edge) and a directed edge with no opposite (a hole or a flipped face).
The padding masks must be prefixes.

``surface_distance`` is the distance of points to a triangle surface:
each query against every face incident to its ``k`` nearest surface
vertices, with the exact point-triangle distance (Ericson, Real-Time
Collision Detection, 5.1.5).  A face that is nearest but shares no
vertex with the k nearest can only make the distance read high.

``mean_edge`` is the mean length of a surface's face edges, the length
the fit's remesh schedule is stated in.

``gaussian_k`` is the Gaussian curvature the neck pass thresholds: at
each vertex a weighted least-squares fit of the second fundamental
form to the normal curvatures along its one-ring edges (angle-weighted
vertex normals, inverse-length weights), K the determinant of the
fitted form, then one one-ring average (the vertex with its
neighbours).  A frozen plain statement of NanoWrap's one-ring
curvature (ch-shrinkwrap ``membrane_mesh_utils.c``, method ``lsq``),
in float64.
"""

import torch


def defects(faces, n_vertices):
    """Counts of a (F, 3) face table's faults over ``n_vertices``."""
    faces = faces.long()
    bad_index = int(((faces < 0) | (faces >= n_vertices)).any(1).sum())
    degenerate = int(((faces[:, 0] == faces[:, 1])
                      | (faces[:, 1] == faces[:, 2])
                      | (faces[:, 2] == faces[:, 0])).sum())
    a = faces.reshape(-1)
    b = faces[:, [1, 2, 0]].reshape(-1)
    key = a * n_vertices + b
    uniq, counts = torch.unique(key, return_counts=True)
    repeated = int((counts > 1).sum())
    twin = b * n_vertices + a
    pos = torch.searchsorted(uniq, twin).clamp(max=uniq.numel() - 1)
    open_edges = int((uniq[pos] != twin).sum())
    return dict(bad_index=bad_index, degenerate=degenerate,
                repeated_edge=repeated, open_edge=open_edges)


def mask_defects(mask):
    """1 when a padding mask is not a run of True then a run of False."""
    m = mask.bool()
    n = int(m.sum())
    return int(not bool(m[:n].all()))


def _point_triangle(p, a, b, c):
    """Distance of points p (..., 3) to triangles (a, b, c) (..., 3)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    bp = p - b
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    cp = p - c
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    den = va + vb + vc
    den = torch.where(den == 0, torch.ones_like(den), den)
    v = vb / den
    w = vc / den
    q = a + ab * v[..., None] + ac * w[..., None]           # inside
    # the seven Voronoi regions of the triangle, the interior last
    t_ab = (d1 / torch.where(d1 - d3 == 0, torch.ones_like(d1), d1 - d3))
    t_ac = (d2 / torch.where(d2 - d6 == 0, torch.ones_like(d2), d2 - d6))
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / torch.where(den_bc == 0, torch.ones_like(den_bc),
                                   den_bc)
    cases = [
        ((d1 <= 0) & (d2 <= 0), a),
        ((d3 >= 0) & (d4 <= d3), b),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * t_ab[..., None]),
        ((d6 >= 0) & (d5 <= d6), c),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * t_ac[..., None]),
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0),
         b + (c - b) * t_bc[..., None]),
    ]
    for cond, pt in reversed(cases):
        q = torch.where(cond[..., None], pt, q)
    return torch.sqrt(((p - q) ** 2).sum(-1))


def surface_distance(queries, vertices, faces, k=8, chunk=None):
    """(Q,) distance of each query point to the surface (vertices,
    faces), in the queries' dtype."""
    faces = faces.long()
    V = vertices.shape[0]
    # a (chunk, V) distance block of at most about 2e8 entries
    chunk = chunk or max(1, min(2048, int(2e8) // max(V, 1)))
    dev = vertices.device
    # vertex -> incident faces, padded with -1
    fv = faces.reshape(-1)
    fid = torch.arange(faces.shape[0], device=dev).repeat_interleave(3)
    order = torch.sort(fv, stable=True).indices
    sv = fv[order]
    counts = torch.bincount(sv, minlength=V)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(sv.numel(), device=dev) - starts[sv]
    width = int(counts.max())
    inc = torch.full((V, width), -1, dtype=torch.long, device=dev)
    inc[sv, rank] = fid[order]
    out = []
    v2 = (vertices * vertices).sum(1)
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk]
        d2 = (q * q).sum(1)[:, None] + v2[None, :] - 2.0 * (q @ vertices.T)
        near = torch.topk(d2, min(k, V), dim=1, largest=False).indices
        cand = inc[near].reshape(q.shape[0], -1)             # (Q, k*width)
        ok = cand >= 0
        tri = vertices[faces[cand.clamp(min=0)]]             # (Q, C, 3, 3)
        d = _point_triangle(q[:, None, :], tri[..., 0, :], tri[..., 1, :],
                            tri[..., 2, :])
        d = torch.where(ok, d, torch.full_like(d, float('inf')))
        out.append(d.min(1).values)
    return torch.cat(out)


def mean_edge(positions, faces):
    """Mean length of the face edges of (positions, faces)."""
    faces = faces.long()
    e = positions[faces[:, [1, 2, 0]]] - positions[faces]
    return float(torch.sqrt((e * e).sum(-1)).mean())


def _householder(n):
    sign = torch.where(n[:, 0] >= 0, 1.0, -1.0).to(n.dtype)
    u = n.clone()
    u[:, 0] = u[:, 0] + sign
    uu = (u * u).sum(1)
    uu = torch.where(uu > 1e-24, uu, torch.ones_like(uu))
    e1 = torch.stack([-2 * u[:, 0] * u[:, 1] / uu,
                      1 - 2 * u[:, 1] * u[:, 1] / uu,
                      -2 * u[:, 2] * u[:, 1] / uu], 1)
    e2 = torch.stack([-2 * u[:, 0] * u[:, 2] / uu,
                      -2 * u[:, 1] * u[:, 2] / uu,
                      1 - 2 * u[:, 2] * u[:, 2] / uu], 1)
    return e1, e2


def gaussian_k(vertices, faces):
    """(V,) smoothed Gaussian curvature of a closed triangle surface, in
    the vertices' dtype; 0 at a vertex no face uses."""
    faces = faces.long()
    p = vertices
    V = p.shape[0]
    dt = p.dtype
    tri = p[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                           dim=-1)
    nn = torch.sqrt((n * n).sum(-1))
    ok = nn >= 1e-12
    fn = n / torch.where(ok, nn, torch.ones_like(nn))[:, None]
    e_next = tri[:, [1, 2, 0]] - tri
    e_prev = tri[:, [2, 0, 1]] - tri
    ang = torch.atan2(torch.sqrt((torch.linalg.cross(
        e_next, e_prev, dim=-1) ** 2).sum(-1)), (e_next * e_prev).sum(-1))
    corner = fn[:, None, :] * (ang * ok[:, None].to(dt))[..., None]
    vn = torch.zeros((V, 3), dtype=dt, device=p.device)
    vn.index_add_(0, faces.reshape(-1), corner.reshape(-1, 3))
    vnn = torch.sqrt((vn * vn).sum(1))
    vn = torch.where((vnn > 1e-12)[:, None],
                     vn / torch.clamp(vnn, min=1e-12)[:, None],
                     torch.zeros_like(vn))
    # the one-ring: every directed edge of a face, once
    src = faces.reshape(-1)
    dst = faces[:, [1, 2, 0]].reshape(-1)
    key = torch.unique(src * V + dst)
    src, dst = key // V, key % V
    N = vn[src]
    dv = p[dst] - p[src]
    ld = torch.sqrt((dv * dv).sum(1))
    inv = 1.0 / torch.clamp(ld, min=1e-12)
    ndv = (N * dv).sum(1)
    T = -(dv - N * ndv[:, None])
    tn = torch.sqrt((T * T).sum(1))
    T = torch.where((tn > 1e-12)[:, None],
                    T / torch.clamp(tn, min=1e-12)[:, None],
                    torch.zeros_like(T))
    d = (N * dv).sum(1) * inv
    inner = torch.sqrt(torch.clamp(1.0 - d * d, 0.0, 1.0))
    ndiff = torch.sqrt(torch.clamp(2.0 - 2.0 * inner, min=0.0))
    kj = 2.0 * torch.sign(-ndv) * ndiff * inv
    e1, e2 = _householder(vn)
    t1 = (T * e1[src]).sum(1)
    t2 = (T * e2[src]).sum(1)

    def vsum(x):
        out = torch.zeros(V, dtype=dt, device=p.device)
        return out.index_add_(0, src, x)
    r_sum = vsum(inv)
    w = inv / torch.clamp(r_sum, min=1e-300)[src]
    X = [t1 * t1, 2.0 * t1 * t2, t2 * t2]
    g = {(i, j): vsum(w * X[i] * X[j]) for i in range(3)
         for j in range(i, 3)}
    r = [vsum(w * X[i] * kj) for i in range(3)]
    m00, m01, m11 = (vsum(w * kj * t1 * t1), vsum(w * kj * t1 * t2),
                     vsum(w * kj * t2 * t2))
    g00, g01, g02 = g[0, 0], g[0, 1], g[0, 2]
    g11, g12, g22 = g[1, 1], g[1, 2], g[2, 2]
    c00 = g11 * g22 - g12 * g12
    c01 = g02 * g12 - g01 * g22
    c02 = g01 * g12 - g02 * g11
    c11 = g00 * g22 - g02 * g02
    c12 = g01 * g02 - g00 * g12
    c22 = g00 * g11 - g01 * g01
    det = g00 * c00 + g01 * c01 + g02 * c02
    fit = torch.abs(det) > 1e-10
    invd = 1.0 / torch.where(fit, det, torch.ones_like(det))
    a = (c00 * r[0] + c01 * r[1] + c02 * r[2]) * invd
    b = (c01 * r[0] + c11 * r[1] + c12 * r[2]) * invd
    c = (c02 * r[0] + c12 * r[1] + c22 * r[2]) * invd
    # Taubin's form where the ring is singular
    disc = torch.sqrt((m00 - m11) ** 2 + 4.0 * m01 * m01)
    l1, l2 = 0.5 * (m00 + m11 - disc), 0.5 * (m00 + m11 + disc)
    K = torch.where(fit, a * c - b * b, (3 * l1 - l2) * (3 * l2 - l1))
    deg = torch.bincount(src, minlength=V).to(dt)
    K = torch.where(deg > 0, K, torch.zeros_like(K))
    return (K + vsum(K[dst])) / (1.0 + deg)

