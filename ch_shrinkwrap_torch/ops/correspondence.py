"""Point -> nearest-face correspondence on torch tensors.

Counterpart of the JAX package's ``ops/correspondence.py``:

* ``nearest_face_bruteforce`` — exact, streamed over point blocks x
  face chunks with a running (min, argmin) merge.
* ``nearest_face_grid`` — a spatial hash grid over the face centres,
  the 27 cells around each point plus a hashed subsample.
* ``nearest_face_blocked`` — per-block candidate tables for sorted
  points: each face joins its nearest blocks' tables.
* ``nearest_face`` — the grid when a cell size is given, else brute.
* ``nearest_face_windowed`` — the production path: points and faces
  both Hilbert-sorted, each 256-point block searches A = 3 contiguous
  windows of W = 2048 faces at index-diverse anchors plus a shared
  hashed face subsample, through the K1 kernel (``cuda_window``; its
  plain version on the CPU).  ``return_meta`` returns the routing
  metadata the K2 scatter consumes.
* ``refine_correspondence`` — local descent on the face-adjacency graph.
* ``correspondence_weights`` / ``a_apply`` / ``ah_apply`` — the
  inverse-distance weights and the A / A^T operators.
* ``windowed_segment_sum`` — the plain form of the windowed A^T
  accumulation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import fma_f32
from .ordering import _subsample_ids
from . import cuda_window
from .cuda_scatter import route
from .cuda_window import CORR_A, CORR_W

BIG = 3.4e38


def sumsq3(v):
    """|v|^2 of (..., 3) f32 rows, rounded as the JAX package's jitted
    ``(v * v).sum(-1)`` rounds it: XLA forms the FMA chain
    ``fma(z, z, fma(y, y, x * x))``, here with :func:`fma_f32` (one
    rounding per FMA), so the result does not depend on how torch
    orders or fuses a sum on either device."""
    x, y, z = v.unbind(-1)
    return fma_f32(z, z, fma_f32(y, y, x * x))


def _masked_c2(centers, f_mask):
    return torch.where(f_mask.bool(), sumsq3(centers),
                       torch.full_like(centers[:, 0], BIG))


def _dot3(p, c):
    """(..., n, m) dot products of (..., n, 3) and (..., m, 3) f32 rows,
    in the order of XLA's K = 3 dot, ``fma(z, Z, fma(y, Y, x * X))``."""
    x, y, z = (t.unsqueeze(-1) for t in p.unbind(-1))
    X, Y, Z = (t.unsqueeze(-2) for t in c.unbind(-1))
    return fma_f32(z, Z, fma_f32(y, Y, x * X))


def nearest_face_bruteforce(points, centers, f_mask, face_chunk=4096,
                            point_block=1024):
    """Exact nearest valid face centre for each point: (dist (N,),
    idx (N,) int32).  Ties go to the lowest face id.  The squared
    distances are rounded as the JAX package's jitted ones are (XLA's
    FMA chains, through :func:`sumsq3` and :func:`_dot3`), so the ids
    agree with it even on near-ties; the float64 temporaries of
    :func:`fma_f32` are why the point blocks are small."""
    N = points.shape[0]
    Fp = centers.shape[0]
    c2 = _masked_c2(centers, f_mask)
    d_out = torch.empty((N,), dtype=torch.float32, device=points.device)
    i_out = torch.empty((N,), dtype=torch.int32, device=points.device)
    for p0 in range(0, N, point_block):
        pb = points[p0:p0 + point_block]
        p2 = sumsq3(pb)
        best_d2 = torch.full_like(p2, BIG)
        best_i = torch.zeros(p2.shape, dtype=torch.int64,
                             device=points.device)
        for f0 in range(0, Fp, face_chunk):
            cc = centers[f0:f0 + face_chunk]
            d2 = p2[:, None] + c2[None, f0:f0 + face_chunk] \
                - 2.0 * _dot3(pb, cc)
            dmin, j = torch.min(d2, dim=1)
            upd = dmin < best_d2
            best_d2 = torch.where(upd, dmin, best_d2)
            best_i = torch.where(upd, j + f0, best_i)
        d_out[p0:p0 + point_block] = torch.sqrt(torch.clamp(best_d2,
                                                            min=0.0))
        i_out[p0:p0 + point_block] = best_i.int()
    return d_out, i_out


# ----------------------------------------------------------------------
# spatial-hash grid

_HASH_PRIMES = (73856093, 19349663, 83492791)
_CELL_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dz in (-1, 0, 1)]


def _wrap_i32(x):
    """int64 values wrapped to int32 two's complement (kept as int64)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x)


def _cell_hash(cells, table_size):
    """XOR spatial hash of (..., 3) integer cell coordinates into
    [0, T), with the JAX package's int32 arithmetic: the products wrap,
    ``abs`` of INT_MIN stays negative and ``%`` is a floor-mod.  The
    products are formed in int64 and wrapped explicitly."""
    c = cells.long()
    h = _wrap_i32(c[..., 0] * _HASH_PRIMES[0])
    for k in (1, 2):
        # XOR of sign-extended int32 values stays sign-extended
        h = h ^ _wrap_i32(c[..., k] * _HASH_PRIMES[k])
    h = torch.where(h == -2 ** 31, h, h.abs())
    return torch.remainder(h, table_size)


def _subsample_table(centers, f_mask, n_subsample):
    sub_l = subsample_ids(centers.shape[0], n_subsample,
                          centers.device).long()
    sub_c = centers[sub_l]
    return sub_l, sub_c, _masked_c2(sub_c, f_mask[sub_l])


def _subsample_min(points, p2, sub, row_block=4096):
    """(d2 (n,), face id (n,) i64) of each point's nearest subsample
    face, ``p^2 + c^2 - 2 p.c`` in XLA's rounding, over row blocks so
    the float64 temporaries of :func:`fma_f32` stay small."""
    sub_l, sub_c, sub_c2 = sub
    d_l, i_l = [], []
    for r0 in range(0, points.shape[0], row_block):
        pr = points[r0:r0 + row_block]
        d2s = (p2[r0:r0 + row_block, None] + sub_c2[None, :]
               - 2.0 * _dot3(pr, sub_c))
        dsub, js = torch.min(d2s, dim=1)
        d_l.append(dsub)
        i_l.append(sub_l[js])
    return torch.cat(d_l), torch.cat(i_l)


def nearest_face_grid(points, centers, f_mask, cell_size,
                      table_size=1 << 18, cell_cap=32, n_subsample=2048,
                      point_block=65536):
    """Nearest face through a spatial hash grid over the face centres:
    the 27 cells around each point, up to ``cell_cap`` faces a hash
    bucket, then a brute pass over a hashed ``n_subsample``-face
    subsample that bounds the error of far points.  Exact up to bucket
    truncation for points within about ``cell_size`` of the surface.
    The JAX package's ``nearest_face_grid`` in plain torch: the same
    hash, the same stable bucket order, and its distances rounded as
    XLA rounds them (``(c - p)^2`` summed as an FMA chain).  Returns
    (dist (N,), fid (N,) i32)."""
    N = points.shape[0]
    Fp = centers.shape[0]
    dev = points.device
    # 1 / cell_size rounded to f32, as the jitted division forms it
    inv_h = (torch.tensor(1.0, dtype=torch.float32)
             / torch.tensor(float(cell_size), dtype=torch.float32)).to(dev)
    fhash = _cell_hash(torch.floor(centers * inv_h).int(), table_size)
    fhash = torch.where(f_mask.bool(), fhash,
                        torch.full_like(fhash, table_size))
    order = torch.argsort(fhash, stable=True)
    sorted_hash = fhash[order].contiguous()
    sorted_centers = centers[order]
    sub = _subsample_table(centers, f_mask, n_subsample)
    offs = torch.tensor(_CELL_OFFSETS, dtype=torch.int64, device=dev)
    slots = torch.arange(cell_cap, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    d_out = torch.empty((N,), dtype=torch.float32, device=dev)
    i_out = torch.empty((N,), dtype=torch.int32, device=dev)
    for p0 in range(0, N, point_block):
        pb = points[p0:p0 + point_block]
        pcell = torch.floor(pb * inv_h).int().long()
        best_d2 = torch.full((pb.shape[0],), BIG, dtype=torch.float32,
                             device=dev)
        best_i = torch.zeros((pb.shape[0],), dtype=torch.int64, device=dev)
        for off in offs:
            qh = _cell_hash(pcell + off, table_size)
            start = torch.searchsorted(sorted_hash, qh)
            end = torch.searchsorted(sorted_hash, qh, right=True)
            idx = start[:, None] + slots[None, :]
            idx_c = idx.clamp(0, Fp - 1)
            d2 = sumsq3(sorted_centers[idx_c] - pb[:, None, :])
            d2 = torch.where(idx < end[:, None], d2, big)
            dmin, j = torch.min(d2, dim=1)
            fid = order[torch.gather(idx_c, 1, j[:, None])[:, 0]]
            upd = dmin < best_d2
            best_d2 = torch.where(upd, dmin, best_d2)
            best_i = torch.where(upd, fid, best_i)
        dsub, isub = _subsample_min(pb, sumsq3(pb), sub)
        upd = dsub < best_d2
        best_d2 = torch.where(upd, dsub, best_d2)
        best_i = torch.where(upd, isub, best_i)
        d_out[p0:p0 + point_block] = torch.sqrt(torch.clamp(best_d2,
                                                            min=0.0))
        i_out[p0:p0 + point_block] = best_i.int()
    return d_out, i_out


def _padded_blocks(points, block_size):
    """(nb, B, 3) point blocks; the pad replicates the last point so it
    never pulls a block centroid toward the origin."""
    N = points.shape[0]
    nb = -(-N // block_size)
    p = points
    if nb * block_size != N:
        p = torch.cat([points, points[N - 1:N].expand(
            nb * block_size - N, 3)])
    return p.reshape(nb, block_size, 3)


def block_centroids(blocks):
    """(nb, 3) per-coordinate medians of (nb, B, 3) point blocks, as
    ``jnp.median`` forms them: the mean of the two middle values of an
    even block (``torch.median`` would return the lower one)."""
    s = torch.sort(blocks, dim=1).values
    h = blocks.shape[1] // 2
    if blocks.shape[1] % 2:
        return s[:, h]
    return (s[:, h - 1] + s[:, h]) * 0.5


def _smallest_k(d, k):
    """(rows, k) column ids of each row's k smallest values, ordered by
    (value, id): ``jax.lax.top_k`` of ``-d``, which keeps the lowest
    ids among ties at the k-th value (``torch.topk`` promises nothing
    about ties)."""
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1:]
    lt = d < kth
    eq = d == kth
    n_eq = k - lt.sum(1, keepdim=True)
    sel = lt | (eq & (torch.cumsum(eq.int(), 1) <= n_eq))
    idx = sel.nonzero()[:, 1].reshape(d.shape[0], k)
    order = torch.sort(torch.gather(d, 1, idx), dim=1, stable=True).indices
    return torch.gather(idx, 1, order)


def nearest_face_blocked(points, centers, f_mask, block_size=256,
                         cand_cap=2048, face_k=16, block_chunk=8,
                         face_chunk=16384, n_subsample=2048):
    """Nearest face for spatially sorted points (``fit_point_order``)
    by per-block candidate tables: every valid face joins the tables of
    its ``face_k`` nearest block centroids (per-coordinate medians of
    256-point blocks), each table keeps its ``cand_cap`` nearest faces,
    and each block's points search their table plus a hashed
    ``n_subsample``-face subsample.  Exact when a point's nearest face
    is in its block's table, which the JAX package gives as more than
    99.9% of near-surface points; the rest still match a nearby face.
    The JAX package's ``nearest_face_blocked`` in plain torch, with its
    median, its tie order (lowest face id among equal distances, stable
    (block, distance) sorts) and XLA's rounding of the distances.
    Returns (dist (N,), fid (N,) i32)."""
    N = points.shape[0]
    Fp = centers.shape[0]
    dev = points.device
    blocks = _padded_blocks(points, block_size)
    nb = blocks.shape[0]
    bcent = block_centroids(blocks)
    b2 = sumsq3(bcent)
    k = min(face_k, nb)

    # ---- stage 1: each face's k nearest block centroids
    d2k, blk = [], []
    for f0 in range(0, Fp, face_chunk):
        cc = centers[f0:f0 + face_chunk]
        d2 = sumsq3(cc)[:, None] + b2[None, :] - 2.0 * _dot3(cc, bcent)
        idx = _smallest_k(d2, k)
        d2k.append(torch.gather(d2, 1, idx))
        blk.append(idx)
    d2k = torch.cat(d2k)
    blk = torch.where(f_mask.bool()[:, None], torch.cat(blk),
                      torch.full((Fp, k), nb, dtype=torch.int64,
                                 device=dev))
    pair_block = blk.reshape(-1)
    pair_face = torch.arange(Fp, device=dev).repeat_interleave(k)
    # sort by (block, distance), so the cap keeps the nearest faces
    order_d = torch.argsort(d2k.reshape(-1), stable=True)
    order = order_d[torch.argsort(pair_block[order_d], stable=True)]
    sb = pair_block[order]
    sf = pair_face[order]
    first = torch.searchsorted(sb, torch.arange(nb + 1, device=dev))
    rank = torch.arange(sb.shape[0], device=dev) - first[sb.clamp(0, nb)]
    ok = (sb < nb) & (rank < cand_cap)
    # columns past the fullest table hold no candidate in any block;
    # leaving them out changes no minimum
    width = max(int(rank[ok].max()) + 1 if bool(ok.any()) else 1, 1)
    table = torch.full((nb, width), -1, dtype=torch.int64, device=dev)
    table[sb[ok], rank[ok]] = sf[ok]

    # ---- stage 2: dense (block points x block candidates) tiles
    sub = _subsample_table(centers, f_mask, n_subsample)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    d_out, i_out = [], []
    for b0 in range(0, nb, block_chunk):
        bp = blocks[b0:b0 + block_chunk]                  # (bc, B, 3)
        tb = table[b0:b0 + block_chunk]                   # (bc, C)
        safe = tb.clamp(0, Fp - 1)
        cc = centers[safe]
        valid = tb >= 0
        c2 = torch.where(valid, sumsq3(cc), big)
        p2 = sumsq3(bp)
        d2 = p2[:, :, None] + c2[:, None, :] - 2.0 * _dot3(bp, cc)
        d2 = torch.where(valid[:, None, :], d2, big)
        dmin, j = torch.min(d2, dim=2)                    # (bc, B)
        fid = torch.where(torch.gather(valid, 1, j),
                          torch.gather(safe, 1, j), 0)
        dsub, isub = _subsample_min(bp.reshape(-1, 3), p2.reshape(-1), sub)
        dmin, fid = dmin.reshape(-1), fid.reshape(-1)
        upd = dsub < dmin
        d_out.append(torch.where(upd, dsub, dmin))
        i_out.append(torch.where(upd, isub, fid))
    d2f = torch.cat(d_out)[:N]
    return torch.sqrt(torch.clamp(d2f, min=0.0)), torch.cat(i_out)[:N].int()


def nearest_face(points, centers, f_mask, face_chunk=4096, method='auto',
                 cell_size=None, **kw):
    """Dispatcher: the hash grid when a cell size is given (or
    ``method='grid'``), otherwise the exact brute force."""
    if method == 'grid' or (method == 'auto' and cell_size is not None):
        return nearest_face_grid(points, centers, f_mask, cell_size, **kw)
    return nearest_face_bruteforce(points, centers, f_mask,
                                   face_chunk=face_chunk)


class WindowedMeta(NamedTuple):
    """Routing metadata of a windowed search, consumed by the K2
    scatter: the 128-aligned window starts, each point's subsample
    slot, and the subsample face ids."""
    starts: torch.Tensor    # (nb, A) i32
    js: torch.Tensor        # (N,) i32
    sub_ids: torch.Tensor   # (nsub,) i32


def windowed_anchor_starts(points, centers, f_mask, block_size=256,
                           window=None, n_subsample=1024, n_anchors=None):
    """(nb, A) i32 window starts into the Hilbert-sorted face array:
    per point block, ``n_anchors`` index-diverse anchors among the 12
    subsample faces nearest the block's median centroid.  Points never
    move during a fit and faces drift little within a CG block, so the
    solver computes these once per block."""
    window = CORR_W if window is None else window
    n_anchors = CORR_A if n_anchors is None else n_anchors
    Fp = centers.shape[0]
    window = min(window, Fp)
    dev = points.device
    bcent = block_centroids(_padded_blocks(points, block_size))

    sub_l = subsample_ids(Fp, n_subsample, dev).long()
    sub_c = centers[sub_l]
    sub_c2 = _masked_c2(sub_c, f_mask[sub_l])
    n_pool = 12
    d2b = (sumsq3(bcent)[:, None] + sub_c2[None, :]
           - 2.0 * (bcent @ sub_c.T))
    top = torch.topk(-d2b, min(n_pool, sub_l.numel()), dim=1).indices
    pool = sub_l[top]                                      # (nb, P)
    rows = torch.arange(pool.shape[0], device=dev)
    w_half = window // 2
    anchors = [pool[:, 0]]
    chosen = torch.zeros(pool.shape, dtype=torch.bool, device=dev)
    chosen[:, 0] = True
    for _ in range(1, n_anchors):
        far_from = torch.ones(pool.shape, dtype=torch.bool, device=dev)
        for ch in anchors:
            far_from &= (pool - ch[:, None]).abs() > w_half
        ok = far_from & ~chosen
        # first (nearest) pool entry that is index-far from every
        # chosen anchor, else the first unchosen one
        pick = torch.where(ok.any(1), ok.int().argmax(1),
                           (~chosen).int().argmax(1))
        chosen[rows, pick] = True
        anchors.append(pool[rows, pick])
    anchors = torch.stack(anchors, dim=1)
    starts = torch.clamp(anchors - w_half, 0, max(Fp - window, 0))
    return starts.int()


class WindowedPointsPrep(NamedTuple):
    """Point-side invariants of ``nearest_face_windowed``: the
    (nb, 3, B) transposed blocks and their |p|^2, computed once per CG
    block."""
    blocks_t: torch.Tensor
    p2: torch.Tensor


def windowed_points_prep(points, block_size=256):
    blocks = _padded_blocks(points, block_size)
    return WindowedPointsPrep(blocks_t=blocks.transpose(1, 2).contiguous(),
                              p2=sumsq3(blocks))


def subsample_ids(n_faces, n_subsample=1024, device=None):
    """(nsub,) i32 ids of the hashed face subsample the windowed search
    and the K2 routing share."""
    return torch.from_numpy(_subsample_ids(n_faces, n_subsample)).to(
        device).int()


def nearest_face_windowed(points, centers, f_mask, block_size=256,
                          window=None, n_subsample=1024, return_meta=False,
                          n_anchors=None, starts=None, prep=None,
                          sub_ids=None):
    """Nearest face via contiguous Hilbert windows plus the subsample
    fallback, through the K1 kernel.  Requires points sorted by
    ``fit_point_order`` and faces by the Hilbert order of their
    centres.  ``starts``, ``prep`` and ``sub_ids`` (from
    :func:`subsample_ids`) depend only on the points and the face
    count, so a solver makes them once per block.  Returns
    (dist (N,), fid (N,) i32[, WindowedMeta])."""
    window = CORR_W if window is None else window
    n_anchors = CORR_A if n_anchors is None else n_anchors
    N = points.shape[0]
    Fp = centers.shape[0]
    Fp_al = -(-Fp // 128) * 128
    window = min(window, Fp_al)
    if prep is None:
        prep = windowed_points_prep(points, block_size)
    if starts is None:
        starts = windowed_anchor_starts(
            points, centers, f_mask, block_size=block_size,
            window=window, n_subsample=n_subsample, n_anchors=n_anchors)
    if sub_ids is None:
        sub_ids = subsample_ids(Fp, n_subsample, points.device)
    d2k, fidk, jsk = cuda_window.window_min(
        prep.blocks_t, starts.int(), centers.T.contiguous(),
        _masked_c2(centers, f_mask), sub_ids, window=window,
        n_anchors=n_anchors)
    d2f = (d2k + prep.p2).reshape(-1)[:N]
    fidf = fidk.reshape(-1)[:N]
    d_out = torch.sqrt(torch.clamp(d2f, min=0.0))
    if not return_meta:
        return d_out, fidf
    starts_al = torch.clamp((starts.int() // 128) * 128, 0,
                            max(Fp_al - window, 0)).int()
    return d_out, fidf, WindowedMeta(starts=starts_al,
                                     js=jsk.reshape(-1)[:N],
                                     sub_ids=sub_ids)


def correspondence_weights(positions, faces, point_xyz, nearest_idx):
    """Inverse-distance weights of each point over its nearest face's
    three vertices: (v_idx (N, 3), w (N, 3) row-normalised)."""
    v_idx = faces[nearest_idx.long()]
    fv = positions[v_idx.long()]                      # (N, 3, 3)
    d = torch.sqrt(((fv - point_xyz[:, None, :]) ** 2).sum(-1))
    w = 1.0 / torch.clamp(d, min=1e-6)
    w = w / w.sum(-1, keepdim=True)
    return v_idx, w


def a_apply(f, v_idx, w):
    """Forward operator ``A f = sum_i w_i f[v_idx_i]`` (N, 3)."""
    return (f[v_idx.long()] * w[..., None]).sum(1)


def ah_apply(r, v_idx, w, n_vertices):
    """Adjoint ``A^T r``: point residuals onto the three vertices of
    each point's face."""
    vals = (w[..., None] * r[:, None, :]).reshape(-1, r.shape[1])
    out = torch.zeros((n_vertices, r.shape[1]), dtype=r.dtype,
                      device=r.device)
    out.index_add_(0, v_idx.reshape(-1).long(), vals)
    return out


def refine_correspondence(points, centers, face_nbrs, fid, n_iter=3):
    """Local descent on the face-adjacency graph: ``n_iter`` times,
    move each point to whichever of its face's three edge-neighbours
    has a closer centre."""
    fid = fid.long()
    Fp = centers.shape[0]
    d2 = ((centers[fid] - points) ** 2).sum(-1)
    for _ in range(n_iter):
        nb = face_nbrs[fid].long()                     # (N, 3)
        safe = nb.clamp(0, Fp - 1)
        dd = ((centers[safe] - points[:, None, :]) ** 2).sum(-1)
        dd = torch.where(nb >= 0, dd, torch.full_like(dd, BIG))
        dmin, j = torch.min(dd, dim=1)
        better = dmin < d2
        fid = torch.where(better, torch.gather(safe, 1, j[:, None])[:, 0],
                          fid)
        d2 = torch.where(better, dmin, d2)
    return torch.sqrt(torch.clamp(d2, min=0.0)), fid.int()


def windowed_segment_sum(vals, fid, meta: WindowedMeta, num_segments,
                         block_size=256, window=CORR_W):
    """``segment_sum(vals, fid)`` with the windowed routing: a row goes
    to fid when fid lies in one of its block's windows, else to
    ``meta.sub_ids[meta.js]``.  The plain form of the K2 kernel for any
    column count."""
    W = min(window, -(-num_segments // 128) * 128)
    tgt = route(fid, meta.js, meta.starts, meta.sub_ids, W, block_size,
                discard_sub=False)
    keep = (tgt >= 0) & (tgt < num_segments)
    out = torch.zeros((num_segments, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    out.index_add_(0, tgt[keep], vals[keep])
    return out
