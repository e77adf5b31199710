"""K1: the windowed nearest-face search kernel and its plain version.

``window_min`` is the port of the JAX package's ``window_min_pallas``
(``ops/pallas_kernels.py:118``): per 256-point block, the min and argmin
of ``|c|^2 - 2 p.c`` over the concatenation of the block's A windows of
W Hilbert-ordered face centres and the shared face subsample.  On a CUDA
tensor it launches ``csrc/window.cu``; on a CPU tensor it runs
``window_min_plain``.

Both follow the arithmetic of the JAX reference: XLA forms the K = 3
``dot_general`` as the FMA chain ``fma(z, Z, fma(y, Y, x * X))`` and
then ``c2 - 2 * dot``.  The face table is stored pre-scaled as
``(-2x, -2y, -2z, c2)``; scaling by -2 commutes exactly with rounding,
so ``c2 + fma(z, -2Z, fma(y, -2Y, x * -2X))`` is bit-equal to the
reference's distance and costs the kernel four fp32 instructions a
candidate.  The plain version forms the same FMAs with
:func:`~ch_shrinkwrap_torch.utils.math.fma_f32`, so kernel, plain
version and the JAX package agree bit for bit, and a near-tie argmin
cannot flip between them.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.math import fma_f32
from . import _build

BIG = 3.4e38
# width and count of the contiguous Hilbert face windows each 256-point
# block searches; K2 routes rows through the same windows
CORR_W = 2048
CORR_A = 3


def _pack(starts, centers_t, c2, sub_ids, window):
    """Kernel-ready inputs shared by the kernel and its plain version:
    starts rounded down to 128 and clamped to the 128-aligned table,
    the (Fp_al, 4) [-2x, -2y, -2z, c2] face table padded with
    (0, 0, 0, BIG), and the (nsub, 4) subsample rows."""
    Fp = centers_t.shape[1]
    Fp_al = -(-Fp // 128) * 128
    if window > Fp_al:
        raise ValueError(f'window {window} exceeds the 128-aligned face '
                         f'table ({Fp_al})')
    starts_al = torch.clamp((starts.int() // 128) * 128, 0,
                            max(Fp_al - window, 0)).int().contiguous()
    cand4 = torch.zeros((Fp_al, 4), dtype=torch.float32,
                        device=centers_t.device)
    cand4[:Fp, :3] = centers_t.T * -2.0
    cand4[:Fp, 3] = c2
    cand4[Fp:, 3] = BIG
    sub_ids = sub_ids.int().contiguous()
    sub4 = cand4[sub_ids.long()].contiguous()
    return starts_al, cand4, sub4, sub_ids


def _check(blocks_t, starts, centers_t, c2, sub_ids, n_anchors):
    if blocks_t.dim() != 3 or blocks_t.shape[1] != 3:
        raise ValueError(f'blocks_t must be (nb, 3, B), got '
                         f'{tuple(blocks_t.shape)}')
    nb, _, B = blocks_t.shape
    if tuple(starts.shape) != (nb, n_anchors):
        raise ValueError(f'starts must be ({nb}, {n_anchors}), got '
                         f'{tuple(starts.shape)}')
    if centers_t.dim() != 2 or centers_t.shape[0] != 3 \
            or tuple(c2.shape) != (centers_t.shape[1],):
        raise ValueError('centers_t must be (3, Fp) and c2 (Fp,)')
    for t in (blocks_t, centers_t, c2):
        if t.dtype != torch.float32:
            raise TypeError(f'expected float32, got {t.dtype}')
    if sub_ids.dim() != 1 or sub_ids.numel() == 0:
        raise ValueError('sub_ids must be a non-empty 1-D index array')


def window_min(blocks_t, starts, centers_t, c2, sub_ids, window=CORR_W,
               n_anchors=CORR_A):
    """Windowed (min |p-c|^2 - |p|^2, argmin face id, subsample slot).

    blocks_t : (nb, 3, B) f32 — transposed point blocks
    starts : (nb, A) int — window starts (rounded down to 128 here)
    centers_t : (3, Fp) f32 — face centres in Hilbert order
    c2 : (Fp,) f32 — |c|^2, BIG on invalid faces
    sub_ids : (nsub,) int — subsample face ids
    Returns (d2 (nb, B) f32, fid (nb, B) i32, js (nb, B) i32); the caller
    adds |p|^2.
    """
    _check(blocks_t, starts, centers_t, c2, sub_ids, n_anchors)
    if blocks_t.device.type == 'cpu':
        return window_min_plain(blocks_t, starts, centers_t, c2, sub_ids,
                                window, n_anchors)
    starts_al, cand4, sub4, sub_i = _pack(starts, centers_t, c2, sub_ids,
                                          window)
    nb, _, B = blocks_t.shape
    pts = blocks_t.contiguous()
    _build.require_cuda(pts, starts_al, cand4, sub4, sub_i)
    d2 = torch.empty((nb, B), dtype=torch.float32, device=pts.device)
    fid = torch.empty((nb, B), dtype=torch.int32, device=pts.device)
    js = torch.empty((nb, B), dtype=torch.int32, device=pts.device)
    L = _build.lib()
    err = L.csw_window_min(
        pts.data_ptr(), starts_al.data_ptr(), cand4.data_ptr(),
        sub4.data_ptr(), sub_i.data_ptr(), nb, B, n_anchors, window,
        sub_i.numel(), d2.data_ptr(), fid.data_ptr(), js.data_ptr(),
        _build.stream_ptr(pts))
    _build.check(err, 'window_min')
    window_min.launches += 1
    return d2, fid, js


window_min.launches = 0


def schedule():
    """The kernel's seams, as the built ``csrc/window.cu`` reports them:
    ``(tile, group_span, chunk)``, the candidates staged at a time, a
    thread group's span of a tile, and the candidates of one chunk of
    the argmin.  The tie tests place ties on them.  Needs the kernel
    library, so the CUDA toolkit."""
    out = [ctypes.c_int() for _ in range(3)]
    _build.lib().csw_window_schedule(*(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def window_min_plain(blocks_t, starts, centers_t, c2, sub_ids,
                     window=CORR_W, n_anchors=CORR_A, block_chunk=None):
    """Plain PyTorch version of :func:`window_min`: a loop over chunks
    of point blocks, the candidate distances formed with the kernel's
    FMA chain (:func:`fma_f32`, float64 temporaries, hence the chunks),
    and ``torch.argmin`` (first index on ties)."""
    _check(blocks_t, starts, centers_t, c2, sub_ids, n_anchors)
    starts_al, cand4, sub4, sub_i = _pack(starts, centers_t, c2, sub_ids,
                                          window)
    nb, _, B = blocks_t.shape
    dev = blocks_t.device
    A, W = n_anchors, window
    n_win = A * W
    if block_chunk is None:
        block_chunk = 32 if dev.type == 'cuda' else 4
    offs = torch.arange(W, device=dev, dtype=torch.int64)
    d_out = torch.empty((nb, B), dtype=torch.float32, device=dev)
    fid_out = torch.empty((nb, B), dtype=torch.int32, device=dev)
    js_out = torch.empty((nb, B), dtype=torch.int32, device=dev)
    for b0 in range(0, nb, block_chunk):
        b1 = min(nb, b0 + block_chunk)
        st = starts_al[b0:b1].long()                       # (bc, A)
        win_ids = (st[:, :, None] + offs).reshape(b1 - b0, n_win)
        cand = torch.cat([cand4[win_ids],
                          sub4[None].expand(b1 - b0, -1, -1)],
                         dim=1)                            # (bc, n, 4)
        p = blocks_t[b0:b1]                                # (bc, 3, B)
        px, py, pz = (p[:, k, :, None] for k in range(3))  # (bc, B, 1)
        cx, cy, cz, cc2 = (cand[:, None, :, k] for k in range(4))
        d = cc2 + fma_f32(pz, cz, fma_f32(py, cy, px * cx))  # (bc, B, n)
        j = torch.argmin(d, dim=2)                         # (bc, B)
        d_out[b0:b1] = torch.gather(d, 2, j[..., None])[..., 0]
        a = torch.clamp(j // W, max=A - 1)
        fid_win = torch.gather(st, 1, a) + (j - a * W)
        fid_sub = sub_i.long()[torch.clamp(j - n_win, 0,
                                           sub_i.numel() - 1)]
        fid_out[b0:b1] = torch.where(j < n_win, fid_win, fid_sub).int()
        js_out[b0:b1] = torch.clamp(j - n_win, min=0).int()
    return d_out, fid_out, js_out
