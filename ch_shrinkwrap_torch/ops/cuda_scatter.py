"""K2: the windowed segment-sum (A^T scatter) kernel and its plain version.

``windowed_scatter`` is the port of the JAX package's sliding-ring
scatter (``ops/pallas_scatter.py:257``): an exact segment-sum of per-point
rows onto faces, where each row goes to its face when the face lies in
one of its 256-point block's windows, else to its subsample face
``sub_ids[js]`` (or is dropped with ``discard_sub``).  The four modes of
the JAX package are thin wrappers over it: ``windowed_ah`` (12 columns
``w_j * [res, 1]``), ``windowed_ahw2`` (those plus the 6 products
``w_j w_j'``), ``windowed_w2`` and ``windowed_segment_sum_cuda`` (up to 12
given columns).  On a CUDA tensor ``windowed_scatter`` launches
``csrc/scatter.cu``; on a CPU tensor it runs ``windowed_scatter_plain``
(the same routing, then ``index_add_``).
"""

from __future__ import annotations

import torch

from . import _build
from .cuda_window import CORR_W

MODES = {'given': 0, 'ah': 1, 'ahw2': 2, 'w2': 3}
MODE_COLS = {'ah': 12, 'ahw2': 18, 'w2': 6}
MAX_GIVEN_COLS = 12


def _columns(mode, w, res, vals):
    """(N, C) rows of the given mode, formed with the kernel's products."""
    if mode == 'given':
        return vals
    cols = []
    if mode in ('ah', 'ahw2'):
        for j in range(3):
            cols += [w[:, j] * res[:, c] for c in range(3)] + [w[:, j]]
    if mode in ('ahw2', 'w2'):
        cols += [w[:, j] * w[:, jp] for (j, jp) in
                 ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
    return torch.stack(cols, dim=1)


def route(fid, js, starts_al, sub_ids, window, block_size, discard_sub):
    """Target face of every row (-1 = dropped): ``fid`` when it lies in
    one of its block's windows, else ``sub_ids[js]`` (dropped under
    ``discard_sub``)."""
    fid = fid.long()
    blk = torch.arange(fid.shape[0], device=fid.device) // block_size
    st = starts_al.long()[blk]                          # (N, A)
    off = fid[:, None] - st
    in_win = ((off >= 0) & (off < window)).any(1)
    js = js.long()
    ok_sub = (js >= 0) & (js < sub_ids.numel())
    sub_t = torch.where(ok_sub, sub_ids.long()[js.clamp(0, sub_ids.numel()
                                                        - 1)],
                        torch.full_like(js, -1))
    if discard_sub:
        sub_t = torch.full_like(js, -1)
    return torch.where(in_win, fid, sub_t)


def _prepare(mode, w, res, vals, fid, js, starts, sub_ids, num_segments,
             block_size, window):
    if mode not in MODES:
        raise ValueError(f'unknown mode {mode!r}')
    lead = vals if mode == 'given' else w
    N = lead.shape[0]
    if mode == 'given':
        if vals.dim() != 2 or not 1 <= vals.shape[1] <= MAX_GIVEN_COLS:
            raise ValueError(f'at most {MAX_GIVEN_COLS} given columns')
    else:
        if tuple(w.shape) != (N, 3):
            raise ValueError('w must be (N, 3)')
        if mode in ('ah', 'ahw2') and tuple(res.shape) != (N, 3):
            raise ValueError('res must be (N, 3)')
    if fid.shape != (N,) or js.shape != (N,):
        raise ValueError('fid and js must be (N,)')
    nb = starts.shape[0]
    if nb * block_size < N:
        raise ValueError(f'{nb} blocks of {block_size} cannot hold {N} '
                         f'rows')
    if window is None:
        window = CORR_W
    Fp_al = -(-num_segments // 128) * 128
    W = min(window, Fp_al)
    starts_al = torch.clamp((starts.int() // 128) * 128, 0,
                            max(Fp_al - W, 0)).int().contiguous()
    return N, W, starts_al


def windowed_scatter(mode, w, res, vals, fid, js, starts, sub_ids,
                     num_segments, block_size=256, window=None,
                     discard_sub=False):
    """(num_segments, C) segment-sum of the mode's per-point rows
    routed through the windows; ``w``/``res``/``vals`` are None where
    the mode does not read them."""
    lead = vals if mode == 'given' else w
    if lead.device.type == 'cpu':
        return windowed_scatter_plain(mode, w, res, vals, fid, js, starts,
                                      sub_ids, num_segments, block_size,
                                      window, discard_sub)
    N, W, starts_al = _prepare(mode, w, res, vals, fid, js, starts,
                               sub_ids, num_segments, block_size, window)
    C = vals.shape[1] if mode == 'given' else MODE_COLS[mode]
    f32 = [t.contiguous() for t in (w, res, vals) if t is not None]
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f'expected float32, got {t.dtype}')
    fid_i = fid.int().contiguous()
    js_i = js.int().contiguous()
    sub_i = sub_ids.int().contiguous()
    _build.require_cuda(*f32, fid_i, js_i, starts_al, sub_i)
    out = torch.zeros((num_segments, C), dtype=torch.float32,
                      device=lead.device)

    def ptr(t):
        return None if t is None else t.contiguous().data_ptr()

    L = _build.lib()
    err = L.csw_windowed_scatter(
        ptr(w), ptr(res), ptr(vals), fid_i.data_ptr(), js_i.data_ptr(),
        starts_al.data_ptr(), sub_i.data_ptr(), N, block_size,
        starts_al.shape[1], W, sub_i.numel(), num_segments, MODES[mode],
        C, int(bool(discard_sub)), out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, 'windowed_scatter')
    windowed_scatter.launches += 1
    return out


windowed_scatter.launches = 0


def windowed_scatter_plain(mode, w, res, vals, fid, js, starts, sub_ids,
                           num_segments, block_size=256, window=None,
                           discard_sub=False):
    """Plain PyTorch version of :func:`windowed_scatter`: the same
    routing, then ``index_add_``."""
    N, W, starts_al = _prepare(mode, w, res, vals, fid, js, starts,
                               sub_ids, num_segments, block_size, window)
    rows = _columns(mode, w, res, vals)
    tgt = route(fid, js, starts_al, sub_ids, W, block_size, discard_sub)
    keep = (tgt >= 0) & (tgt < num_segments)
    out = torch.zeros((num_segments, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    out.index_add_(0, tgt[keep], rows[keep])
    return out


def windowed_ah(w, res, fid, js, starts, sub_ids, num_segments,
                block_size=256, window=None):
    """A^T accumulation: col 4j+c = w_j res_c (c < 3), col 4j+3 = w_j."""
    return windowed_scatter('ah', w, res, None, fid, js, starts, sub_ids,
                            num_segments, block_size, window)


def windowed_ahw2(w, res, fid, js, starts, sub_ids, num_segments,
                  block_size=256, window=None):
    """One sweep of ``windowed_ah`` and ``windowed_w2``: (ah, w2)."""
    out = windowed_scatter('ahw2', w, res, None, fid, js, starts, sub_ids,
                           num_segments, block_size, window)
    return out[:, :12], out[:, 12:18]


def windowed_w2(w, fid, js, starts, sub_ids, num_segments, block_size=256,
                window=None):
    """Per-face sums of w0w0 w1w1 w2w2 w0w1 w0w2 w1w2."""
    return windowed_scatter('w2', w, None, None, fid, js, starts, sub_ids,
                            num_segments, block_size, window)


def windowed_segment_sum_cuda(vals, fid, js, starts, sub_ids, num_segments,
                              block_size=256, window=None,
                              discard_sub=False):
    """``segment_sum(vals, fid)`` for up to 12 given columns, routed
    through the windows (``discard_sub`` drops unrouted rows)."""
    return windowed_scatter('given', None, None, vals, fid, js, starts,
                            sub_ids, num_segments, block_size, window,
                            discard_sub)
