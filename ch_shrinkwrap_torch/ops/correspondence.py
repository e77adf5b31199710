"""Point -> nearest-face correspondence on torch tensors.

Counterpart of the JAX package's ``ops/correspondence.py``, limited to
the fit's paths:

* ``nearest_face_bruteforce`` — exact, streamed over point blocks x
  face chunks with a running (min, argmin) merge.
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

from .ordering import _subsample_ids
from . import cuda_window
from .cuda_scatter import route
from .cuda_window import CORR_A, CORR_W

BIG = 3.4e38


def _masked_c2(centers, f_mask):
    return torch.where(f_mask.bool(), (centers * centers).sum(-1),
                       torch.full_like(centers[:, 0], BIG))


def nearest_face_bruteforce(points, centers, f_mask, face_chunk=4096,
                            point_block=8192):
    """Exact nearest valid face centre for each point: (dist (N,),
    idx (N,) int32).  Ties go to the lowest face id."""
    N = points.shape[0]
    Fp = centers.shape[0]
    c2 = _masked_c2(centers, f_mask)
    d_out = torch.empty((N,), dtype=torch.float32, device=points.device)
    i_out = torch.empty((N,), dtype=torch.int32, device=points.device)
    for p0 in range(0, N, point_block):
        pb = points[p0:p0 + point_block]
        p2 = (pb * pb).sum(-1)
        best_d2 = torch.full_like(p2, BIG)
        best_i = torch.zeros(p2.shape, dtype=torch.int64,
                             device=points.device)
        for f0 in range(0, Fp, face_chunk):
            cc = centers[f0:f0 + face_chunk]
            d2 = p2[:, None] + c2[None, f0:f0 + face_chunk] \
                - 2.0 * (pb @ cc.T)
            dmin, j = torch.min(d2, dim=1)
            upd = dmin < best_d2
            best_d2 = torch.where(upd, dmin, best_d2)
            best_i = torch.where(upd, j + f0, best_i)
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
    blocks = _padded_blocks(points, block_size)
    s = torch.sort(blocks, dim=1).values
    h = block_size // 2
    if block_size % 2:
        bcent = s[:, h]
    else:
        bcent = (s[:, h - 1] + s[:, h]) * 0.5              # (nb, 3)

    sub_ids = torch.from_numpy(_subsample_ids(Fp, n_subsample)).to(dev)
    sub_l = sub_ids.long()
    sub_c = centers[sub_l]
    sub_c2 = _masked_c2(sub_c, f_mask[sub_l])
    n_pool = 12
    d2b = ((bcent * bcent).sum(-1)[:, None] + sub_c2[None, :]
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
                              p2=(blocks * blocks).sum(-1))


def nearest_face_windowed(points, centers, f_mask, block_size=256,
                          window=None, n_subsample=1024, return_meta=False,
                          n_anchors=None, starts=None, prep=None):
    """Nearest face via contiguous Hilbert windows plus the subsample
    fallback, through the K1 kernel.  Requires points sorted by
    ``fit_point_order`` and faces by the Hilbert order of their
    centres.  Returns (dist (N,), fid (N,) i32[, WindowedMeta])."""
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
    sub_ids = torch.from_numpy(_subsample_ids(Fp, n_subsample)).to(
        points.device)
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
                                     sub_ids=sub_ids.int())


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
