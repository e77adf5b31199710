"""Plain reference of one CG block of the NanoWrap fit.

A straightforward PyTorch statement of what one block of
``MembraneMesh.shrink_wrap`` computes, for ``num_iters`` iterations,
from the block's starting state (padded positions and faces, their
masks, the cloud in the fit's point order):

1. face corners, centres and angle-weighted vertex-normal corners;
2. each point's nearest face centre: over every valid face
   (``'brute'``), or over the candidates the windowed search defines
   (``'windowed'``: each 256-point block searches 3 windows of 2048
   faces of the face table, placed at anchors among the 12 subsample
   faces nearest the block's median point, plus the shared hashed
   subsample of 1024 faces; the first minimum in that order wins);
3. inverse-distance weights over the face's corners, the forward map and
   the weighted, distance-damped residuals;
4. A^T of [residual, 1] onto faces, folded onto vertices with the normal
   corners (S0, the vertex normals and the point influence);
5. the curvature-aware ``_ncc`` prior from each vertex's one-ring;
6. with ``use_shrink``, the shrink prior ``30 max(1 - |A^T 1|, 0) n``;
7. the subspace step: H and G over the directions [S0, -prior(s),
   previous step], the small solve, the update, and the early stop.

Everything runs in ``dtype`` (float64 for the reference, bfloat16 for
the control); only the <= 4 x 4 solve is widened to float32 where
``dtype`` is narrower, since ``torch.linalg.solve`` has no bfloat16.
Nothing here comes from the program: the one-ring, the anchors, the
windows and the subsample are worked out again from the faces and the
positions.  Frozen constants: the window (2048), anchor count (3),
anchor pool (12), subsample size (1024) and hash, block size (256) and
neighbour-table width (20) of the method the port implements.
"""

import numpy as np
import torch

WINDOW = 2048
N_ANCHORS = 3
ANCHOR_POOL = 12
N_SUB = 1024
BLOCK = 256
NBR_K = 20
BIG = 3.4e38


def _big(dtype):
    return min(BIG, torch.finfo(dtype).max)


def subsample_ids(n_total, n_sub=N_SUB):
    """The windowed search's face subsample: one hash-jittered id per
    ``n_total / n_sub`` stratum, sorted and unique."""
    n_sub = min(n_sub, n_total)
    i = np.arange(n_sub, dtype=np.uint64)
    base = i * np.uint64(n_total) // np.uint64(n_sub)
    strat = max(n_total // n_sub, 1)
    jit = ((i * np.uint64(2654435761)) >> np.uint64(17)) \
        % np.uint64(strat)
    ids = np.minimum(base + jit, np.uint64(n_total - 1))
    return np.unique(ids.astype(np.int64))


def one_ring(faces, n_vertices, k=NBR_K):
    """(V, k) heads of each vertex's outgoing halfedges, in face order,
    -1 padded; the first ``k`` of a vertex with more."""
    src = faces.reshape(-1)
    dst = faces[:, [1, 2, 0]].reshape(-1)
    order = torch.sort(src, stable=True).indices
    ssrc = src[order]
    counts = torch.bincount(ssrc, minlength=n_vertices)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(ssrc.numel(), device=faces.device) - starts[ssrc]
    nbr = torch.full((n_vertices, k), -1, dtype=torch.long,
                     device=faces.device)
    ok = rank < k
    nbr[ssrc[ok], rank[ok]] = dst[order[ok]]
    return nbr


def _median_rows(blocks):
    s = torch.sort(blocks, dim=1).values
    h = blocks.shape[1] // 2
    if blocks.shape[1] % 2:
        return s[:, h]
    return (s[:, h - 1] + s[:, h]) * 0.5


def _blocks(points, block):
    n = points.shape[0]
    nb = -(-n // block)
    if nb * block != n:
        points = torch.cat([points, points[n - 1:n].expand(
            nb * block - n, 3)])
    return points.reshape(nb, block, 3)


def window_candidates(points, centers, valid, block=BLOCK, window=WINDOW,
                      n_anchors=N_ANCHORS, n_sub=N_SUB):
    """(nb, A W + nsub) candidate face ids of each point block, in the
    windowed search's order; ids past the face table are padding."""
    Fp = centers.shape[0]
    Fp_al = -(-Fp // 128) * 128
    dev = points.device
    sub = torch.from_numpy(subsample_ids(Fp, n_sub)).to(dev)
    bcent = _median_rows(_blocks(points, block))
    sc = centers[sub]
    d2b = ((bcent * bcent).sum(1)[:, None] + (sc * sc).sum(1)[None, :]
           - 2.0 * (bcent @ sc.T))
    d2b = torch.where(valid[sub][None, :], d2b,
                      torch.full_like(d2b, float('inf')))
    top = torch.topk(-d2b, min(ANCHOR_POOL, sub.numel()),
                     dim=1).indices
    pool = sub[top]
    rows = torch.arange(pool.shape[0], device=dev)
    w_anchor = min(window, Fp)
    half = w_anchor // 2
    anchors = [pool[:, 0]]
    chosen = torch.zeros(pool.shape, dtype=torch.bool, device=dev)
    chosen[:, 0] = True
    for _ in range(1, n_anchors):
        far = torch.ones(pool.shape, dtype=torch.bool, device=dev)
        for a in anchors:
            far &= (pool - a[:, None]).abs() > half
        ok = far & ~chosen
        pick = torch.where(ok.any(1), ok.int().argmax(1),
                           (~chosen).int().argmax(1))
        chosen[rows, pick] = True
        anchors.append(pool[rows, pick])
    starts = torch.clamp(torch.stack(anchors, 1) - half, 0,
                         max(Fp - w_anchor, 0))
    w_search = min(window, Fp_al)
    starts = torch.clamp((starts // 128) * 128, 0, max(Fp_al - w_search, 0))
    span = torch.arange(w_search, device=dev)
    win = (starts[:, :, None] + span).reshape(starts.shape[0], -1)
    return torch.cat([win, sub[None, :].expand(starts.shape[0], -1)], 1)


def nearest_faces(points, centers, valid, cand=None):
    """(distance to the nearest face centre (N,), face id (N,)): over
    every valid face, or with ``cand`` (from :func:`window_candidates`)
    over each point block's candidates, the first minimum winning."""
    if cand is not None:
        return _search(points, centers, valid, cand)
    c2 = torch.where(valid, (centers * centers).sum(1),
                     torch.full_like(centers[:, 0], _big(centers.dtype)))
    d_out, i_out = [], []
    for p0 in range(0, points.shape[0], 4096):
        p = points[p0:p0 + 4096]
        d2 = (p * p).sum(1)[:, None] + c2[None, :] - 2.0 * (p @ centers.T)
        d, i = torch.min(d2, 1)
        d_out.append(d)
        i_out.append(i)
    return torch.sqrt(torch.clamp(torch.cat(d_out), min=0)), torch.cat(i_out)


def normal_corners(tri, fmask):
    """(Fp, 3, 3) angle-weighted vertex-normal contributions."""
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
                           dim=-1)
    nn = torch.sqrt((n * n).sum(-1))
    fn = n / torch.clamp(nn, min=1e-12)[:, None] * fmask[:, None]
    e_next = tri[:, [1, 2, 0]] - tri
    e_prev = tri[:, [2, 0, 1]] - tri
    dot = (e_next * e_prev).sum(-1)
    crs = torch.linalg.cross(e_next, e_prev, dim=-1)
    ang = torch.atan2(torch.sqrt((crs * crs).sum(-1)), dot) * fmask[:, None]
    return fn[:, None, :] * ang[:, :, None]


def unit(v):
    return v / torch.clamp(torch.sqrt((v * v).sum(-1)), min=1e-12)[:, None]


def ncc_prior(f, nbr, vn, pinf, vmask):
    Vp = f.shape[0]
    nm = ((nbr >= 0) & vmask.bool()[:, None]).to(f.dtype)
    j = nbr.clamp(0, Vp - 1)
    vpos, n_n = f[j], vn[j]
    ms = nm.sum(-1)
    sum_pos = (vpos * nm[..., None]).sum(1)
    vc = sum_pos / torch.clamp(ms, min=1.0)[:, None]
    c_n = (vpos - vc[:, None, :]) * nm[..., None]
    ndn = (n_n * vn[:, None, :]).sum(-1)
    alpha = ((c_n * n_n).sum(-1)
             / torch.sqrt(2.0 * (torch.clamp(ndn, min=0.0) + 1.0)))
    a_num = (alpha * nm).sum(-1) / torch.clamp(ms, min=1.0)
    a_num = a_num * torch.clamp(pinf ** 2, max=1.0)
    out = vc + a_num[:, None] * vn
    return torch.where((ms == 0)[:, None], f, out)


def cg_block(positions, faces, f_mask, v_mask, points, sigma_inv, weights,
             point_mask, lam0, shrink_lam, num_iters, active_iters,
             use_shrink, method, dtype=torch.float64, stop_eps=1e-6):
    """The block's final (Vp, 3) positions, in ``dtype``."""
    dev = positions.device
    f = positions.to(dtype)
    faces = faces.long()
    fmask = f_mask.to(dtype)
    valid = f_mask.bool()
    vm3 = v_mask.to(dtype)[:, None]
    pts = points.to(dtype)
    sinv = sigma_inv.to(dtype)
    wts = weights.to(dtype)
    pm3 = point_mask.to(dtype)[:, None]
    el = ((weights > 0) & point_mask.bool()[:, None]).to(dtype)
    Vp, Fp, N = f.shape[0], faces.shape[0], pts.shape[0]
    nbr = one_ring(faces[valid], Vp)
    n0 = 3 if use_shrink else 2
    s = n0 + 1
    lam2 = [float(np.float32(lam0) ** 2), float(np.float32(shrink_lam) ** 2)]
    S_last = torch.zeros_like(f)
    hist = [float('inf')] * 3
    halted = False
    # the statistic and the small solve in at least float32
    sd = torch.promote_types(dtype, torch.float32)
    n_act = num_iters if active_iters is None else int(active_iters)
    # the windowed candidates are placed once per block, from the
    # block's starting centres
    cand = window_candidates(pts, f[faces].mean(1), valid) \
        if method == 'windowed' else None
    for it in range(num_iters):
        if halted or it >= n_act:
            continue
        tri = f[faces]
        centers = tri.mean(1)
        vnc = normal_corners(tri, fmask)
        d, fi = nearest_faces(pts, centers, valid, cand)
        fv = tri[fi]                                        # (N, 3, 3)
        dv = torch.sqrt(((fv - pts[:, None, :]) ** 2).sum(-1))
        w = 1.0 / torch.clamp(dv, min=1e-6)
        w = w / w.sum(-1, keepdim=True) * pm3
        Af = (fv * w[..., None]).sum(1)
        res = wts * (pts - Af)
        res = res / (d[:, None] * sinv / 2.0 + 1.0) * pm3
        rows = torch.cat([res, pm3], 1)                     # (N, 4)
        acc = torch.zeros((Fp, 3, 4), dtype=dtype, device=dev)
        acc.index_add_(0, fi, w[..., None] * rows[:, None, :])
        corner = torch.cat([vnc, acc], 2).reshape(Fp * 3, 7)
        corner = corner * fmask.repeat_interleave(3)[:, None]
        out7 = torch.zeros((Vp, 7), dtype=dtype, device=dev)
        out7.index_add_(0, faces.reshape(-1), corner)
        vn = unit(out7[:, :3])
        pinf = (3.0 ** 0.5) * torch.abs(out7[:, 6])
        ncc = ncc_prior(f, nbr, vn, pinf, v_mask)
        S0 = out7[:, 3:6] * vm3
        pref0 = (f - ncc) * vm3
        prefs, dirs = [pref0], [S0, -pref0]
        if use_shrink:
            pref1 = 30.0 * (torch.clamp(1.0 - pinf, min=0.0)[:, None]
                            * vn) * vm3
            prefs.append(pref1)
            dirs.append(-pref1)
        dirs.append(S_last)
        S = torch.stack(dirs, -1)                           # (Vp, 3, s)
        n_active = s if it > 0 else n0
        pairs = [(i, j) for i in range(n0) for j in range(1, n0) if i != j]
        test = 1.0
        Ss = S.to(sd)
        for i, j in pairs:
            num = (Ss[..., i] * Ss[..., j]).sum()
            den = torch.linalg.norm(Ss[..., i]) * torch.linalg.norm(Ss[..., j])
            test = test - float(torch.abs(num)
                                / torch.clamp(den, min=1e-30)) / len(pairs)
        AS = (S[faces[fi]] * w[:, :, None, None]).sum(1)    # (N, 3, s)
        ASm = AS * el[..., None]
        H = torch.einsum('nik,nil->kl', ASm, ASm)
        G = torch.einsum('nik,ni->k', ASm, res * el)
        Sv = S * vm3[..., None]
        Hw = torch.einsum('vik,vil->kl', Sv, Sv)
        for l2, pref in zip(lam2, prefs):
            H = H + l2 * Hw
            G = G - l2 * torch.einsum('vik,vi->k', Sv, pref)
        act = (torch.arange(s, device=dev) < n_active).to(dtype)
        H = H * act[None, :] * act[:, None] + torch.diag(1.0 - act)
        G = G * act
        H = H.to(sd) + 1e-20 * torch.eye(s, dtype=sd, device=dev)
        c = torch.linalg.solve(H, G.to(sd)).to(dtype)
        fnew = f + torch.einsum('vik,k->vi', S, c) * vm3
        a_, b_, c3 = hist
        halted = (c3 < b_) and (b_ < a_) and (a_ < stop_eps)
        if not halted:
            S_last = fnew - f
            f = fnew
            hist = [hist[1], hist[2], test]
    return f


def _search(points, centers, valid, cand, chunk=64):
    N = points.shape[0]
    Fp = centers.shape[0]
    Fp_al = -(-Fp // 128) * 128
    blocks = _blocks(points, BLOCK)
    nb = blocks.shape[0]
    dt, dev = centers.dtype, centers.device
    cpad = torch.zeros((Fp_al, 3), dtype=dt, device=dev)
    cpad[:Fp] = centers
    c2pad = torch.full((Fp_al,), BIG, dtype=torch.float64
                       if dt == torch.float64 else torch.float32,
                       device=dev)
    c2pad[:Fp] = torch.where(valid, (centers * centers).sum(1).to(
        c2pad.dtype), torch.full_like(c2pad[:Fp], BIG))
    d_all = torch.empty((nb, BLOCK), dtype=c2pad.dtype, device=dev)
    i_all = torch.empty((nb, BLOCK), dtype=torch.long, device=dev)
    for b0 in range(0, nb, chunk):
        ids = cand[b0:b0 + chunk]
        pb = blocks[b0:b0 + chunk]
        dot = torch.bmm(pb, cpad[ids].transpose(1, 2)).to(c2pad.dtype)
        d2 = (c2pad[ids][:, None, :] - 2.0 * dot
              + (pb * pb).sum(2).to(c2pad.dtype)[:, :, None])
        d, j = torch.min(d2, 2)
        d_all[b0:b0 + chunk] = d
        i_all[b0:b0 + chunk] = torch.gather(ids, 1, j)
    d2 = d_all.reshape(-1)[:N]
    return (torch.sqrt(torch.clamp(d2, min=0)).to(dt),
            i_all.reshape(-1)[:N])
