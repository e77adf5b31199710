"""K2: the windowed segment-sum (A^T scatter) kernel, the ordered segment
sum it is built on, and their plain versions.

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
(the same routing, then the plain ordered sum).

``segment_sum_ordered(rows, target, num_segments)`` (K2s) is the
reduction on its own, for given rows of any width: every accumulation of
the fit on the card goes through it instead of ``index_add_``, whose
CUDA version adds with atomics in an order that changes between runs.

Both sum in one fixed order: each segment is the sum, from zero (or
from ``init``), of its rows in ascending row index, rounded after every
add.  That is the order of ``index_add_`` on the CPU, so the kernels
equal their plain versions bit for bit and a fit on the card gives the
same bits on every run.  On the card the rows are ordered by target
with the kernels' own stable radix ordering of ``bit_length(num_segments)``
key bits (``digit_plan`` chooses its digits; ``segment_order`` is its
plain version), and each segment is folded in that order, by one lane
or, when it is long, by a warp; the plain version on the card adds the
k-th row of every segment in step k, so no index repeats within one
``index_add_`` and nothing races.

K2 returns the first C columns of a (num_segments, C4) table whose row
stride C4 is C rounded up to a multiple of 4 (12, 20, 8, <= 12), so the
kernel writes each row with 16-byte stores.  Callers pass the window
starts as the search returned them (the kernel rounds them down to 128
and clamps them itself) and ``sub_ids`` as int32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cuda_window import CORR_W

MODES = {'given': 0, 'ah': 1, 'ahw2': 2, 'w2': 3}
MODE_COLS = {'ah': 12, 'ahw2': 18, 'w2': 6}
MAX_GIVEN_COLS = 12
INT32_MAX = 2 ** 31 - 1

# the radix ordering's shape, as csrc/scatter.cu builds it
RADIX_BITS_MAX = 10      # bits a pass sorts
RADIX_WARPS = 8          # warps of a tile, each with its own histogram
RADIX_TILE = 4096        # rows a block ranks in a pass
SMEM_STATIC_MAX = 48 * 1024


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


def segment_order(key, num_segments):
    """Plain version of the card's ordering: the rows in ascending order
    of ``key`` (int32, ``num_segments`` = dropped), rows of one key in
    ascending row index, and each segment's first position in that
    order: (perm int64 (N,), offsets int32 (num_segments + 1,)).  Moves
    indices only.  The kernels do not call it."""
    skey, perm = torch.sort(key, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=key.dtype,
                          device=key.device)
    return perm, torch.searchsorted(skey, bounds, out_int32=True)


def digit_plan(num_segments):
    """The digits ``[(shift, bits), ...]`` of the card's stable LSD radix
    ordering of keys in ``[0, num_segments]`` (``num_segments`` marks a
    dropped row): ``bit_length(num_segments)`` bits in the fewest passes
    of at most ``RADIX_BITS_MAX`` bits, split as evenly as they go."""
    nbits = max(int(num_segments).bit_length(), 1)
    npass = -(-nbits // RADIX_BITS_MAX)
    base, extra = divmod(nbits, npass)
    plan, shift = [], 0
    for p in range(npass):
        bits = base + (p < extra)
        plan.append((shift, bits))
        shift += bits
    return plan


def radix_smem_bytes(bits):
    """Shared memory of a pass's scatter kernel (the larger of its two
    kernels): a histogram of ``2**bits`` counts for each warp of the
    tile, which then holds the tile's keys and values in digit order,
    each digit's offset, and the two scans' warp sums (4 digits a
    thread)."""
    R = 1 << bits
    return ((max(RADIX_WARPS * R, 2 * RADIX_TILE) + R) * 4
            + 2 * 4 * RADIX_WARPS * 4)


def _order_args(N, num_segments, device):
    """(plan as a C int array, passes, int32 workspace) of one ordering:
    4 N keys and indices, the offsets, the digit totals and the tile x
    digit counts of the widest pass."""
    if N > INT32_MAX - RADIX_TILE:
        raise ValueError(f'{N} rows: the ordering takes fewer than '
                         f'2**31 - {RADIX_TILE}')
    plan = digit_plan(num_segments)
    flat = [v for sb in plan for v in sb]
    R = 1 << max(b for _, b in plan)
    T = -(-N // RADIX_TILE)
    ws = torch.empty(4 * N + num_segments + 1 + R + T * R,
                     dtype=torch.int32, device=device)
    return (ctypes.c_int * len(flat))(*flat), len(plan), ws


def _target_dtype(target):
    if target.dtype not in (torch.int32, torch.int64):
        raise TypeError(f'target must be int32 or int64, got '
                        f'{target.dtype}')
    return int(target.dtype == torch.int64)


def radix_order(target, num_segments):
    """The ordering K2 and K2s run on the card, alone: (perm int32 (N,),
    offsets int32 (num_segments + 1,)) of ``segment_order`` on the keys
    ``target``, or ``num_segments`` where it lies outside
    ``[0, num_segments)``.  On a CPU tensor, ``segment_order`` itself."""
    if num_segments < 1 or num_segments >= INT32_MAX:
        raise ValueError('num_segments must lie in [1, 2**31 - 1)')
    if target.device.type == 'cpu':
        t = target.long()
        key = torch.where((t >= 0) & (t < num_segments), t,
                          num_segments).int()
        perm, offsets = segment_order(key, num_segments)
        return perm.int(), offsets
    is64 = _target_dtype(target)
    _build.require_cuda(target)
    N = target.shape[0]
    plan, npass, ws = _order_args(N, num_segments, target.device)
    err = _build.lib().csw_segment_order(
        target.data_ptr(), is64, N, num_segments, plan, npass,
        ws.data_ptr(), ws.numel(), _build.stream_ptr(ws))
    _build.check(err, 'segment_order')
    return ws[N:2 * N], ws[4 * N:4 * N + num_segments + 1]


def _check(mode, w, res, vals, fid, js, starts, num_segments, block_size,
           window):
    """Validate the inputs; returns (N, C, W)."""
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
    if N > INT32_MAX or num_segments >= INT32_MAX:
        raise ValueError('N and num_segments must stay below 2**31')
    if window is None:
        window = CORR_W
    C = vals.shape[1] if mode == 'given' else MODE_COLS[mode]
    return N, C, min(window, -(-num_segments // 128) * 128)


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
    N, C, W = _check(mode, w, res, vals, fid, js, starts, num_segments,
                     block_size, window)
    f32 = [t for t in (w, res, vals) if t is not None]
    for t in f32:
        if t.dtype != torch.float32:
            raise TypeError(f'expected float32, got {t.dtype}')
    for t in (fid, js, starts, sub_ids):
        if t.dtype != torch.int32:
            raise TypeError(f'fid, js, starts and sub_ids must be int32, '
                            f'got {t.dtype}')
    _build.require_cuda(*f32, fid, js, starts, sub_ids)
    dev = lead.device
    C4 = -(-C // 4) * 4
    out = torch.empty((num_segments, C4), dtype=torch.float32, device=dev)
    if num_segments == 0:
        return out[:, :C]

    def ptr(t):
        return None if t is None else t.data_ptr()

    Fp_al = -(-num_segments // 128) * 128
    plan, npass, ws = _order_args(N, num_segments, dev)
    err = _build.lib().csw_windowed_scatter(
        fid.data_ptr(), js.data_ptr(), starts.data_ptr(), sub_ids.data_ptr(),
        N, block_size, starts.shape[1], W, max(Fp_al - W, 0),
        sub_ids.numel(), num_segments, int(bool(discard_sub)),
        ptr(w), ptr(res), ptr(vals), MODES[mode], C, C4, plan, npass,
        ws.data_ptr(), ws.numel(), out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, 'windowed_scatter')
    windowed_scatter.launches += 1
    return out[:, :C]


windowed_scatter.launches = 0


def windowed_scatter_plain(mode, w, res, vals, fid, js, starts, sub_ids,
                           num_segments, block_size=256, window=None,
                           discard_sub=False):
    """Plain PyTorch version of :func:`windowed_scatter`: the same
    routing, then the plain ordered sum into the same padded-stride
    table."""
    N, C, W = _check(mode, w, res, vals, fid, js, starts, num_segments,
                     block_size, window)
    Fp_al = -(-num_segments // 128) * 128
    starts_al = torch.clamp((starts.int() // 128) * 128, 0,
                            max(Fp_al - W, 0))
    rows = _columns(mode, w, res, vals)
    C4 = -(-C // 4) * 4
    if C4 > C:
        rows = torch.cat([rows, rows.new_zeros((N, C4 - C))], dim=1)
    tgt = route(fid, js, starts_al, sub_ids, W, block_size, discard_sub)
    return segment_sum_ordered_plain(rows, tgt, num_segments)[:, :C]


def _check_segment(rows, target, num_segments, init):
    if rows.dim() not in (1, 2):
        raise ValueError(f'rows must be (N,) or (N, C), got '
                         f'{tuple(rows.shape)}')
    if target.shape != rows.shape[:1]:
        raise ValueError(f'target must be ({rows.shape[0]},), got '
                         f'{tuple(target.shape)}')
    shape = (num_segments,) + tuple(rows.shape[1:])
    if init is not None and (tuple(init.shape) != shape
                             or init.dtype != rows.dtype):
        raise ValueError(f'init must be {shape} {rows.dtype}')
    C = rows.shape[1] if rows.dim() == 2 else 1
    if rows.shape[0] > INT32_MAX or num_segments * max(C, 1) > INT32_MAX:
        raise ValueError('rows and the table must stay below 2**31')
    return shape, C


def segment_sum_ordered(rows, target, num_segments, init=None):
    """``out[s] = init[s] (or 0) + sum of rows[n] with target[n] == s``,
    added in ascending n; rows whose target lies outside
    ``[0, num_segments)`` are dropped.  ``rows`` (N,) or (N, C), float32
    (any type on the CPU)."""
    shape, C = _check_segment(rows, target, num_segments, init)
    if rows.device.type == 'cpu':
        return segment_sum_ordered_plain(rows, target, num_segments, init)
    if rows.dtype != torch.float32:
        raise TypeError(f'rows must be float32, got {rows.dtype}')
    is64 = _target_dtype(target)
    rows_c, target_c = rows.contiguous(), target.contiguous()
    init_c = None if init is None else init.contiguous()
    _build.require_cuda(rows_c, target_c,
                        *(() if init_c is None else (init_c,)))
    out = torch.empty(shape, dtype=rows.dtype, device=rows.device)
    if num_segments == 0:
        return out
    N = rows.shape[0]
    plan, npass, ws = _order_args(N, num_segments, rows.device)
    err = _build.lib().csw_segment_sum(
        rows_c.data_ptr(), target_c.data_ptr(), is64, N, num_segments, C,
        None if init_c is None else init_c.data_ptr(), plan, npass,
        ws.data_ptr(), ws.numel(), out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, 'segment_sum')
    segment_sum_ordered.launches += 1
    return out


segment_sum_ordered.launches = 0


def segment_sum_ordered_plain(rows, target, num_segments, init=None):
    """Plain PyTorch version of :func:`segment_sum_ordered`:
    ``index_add_`` on the CPU, which adds each segment's rows in
    ascending row index; on the card :func:`segment_sum_stepwise`."""
    shape, _ = _check_segment(rows, target, num_segments, init)
    if rows.device.type != 'cpu':
        return segment_sum_stepwise(rows, target, num_segments, init)
    t = target.long()
    keep = (t >= 0) & (t < num_segments)
    out = rows.new_zeros(shape) if init is None else init.clone()
    return out.index_add_(0, t[keep], rows[keep])


def segment_sum_stepwise(rows, target, num_segments, init=None):
    """The ordered sum on any device without a racing add: step k adds
    the k-th row (in ascending row index) of every segment, so no index
    repeats within one ``index_add_``.  As many steps as the longest
    segment has rows."""
    shape, _ = _check_segment(rows, target, num_segments, init)
    out = rows.new_zeros(shape) if init is None else init.clone()
    t = target.long()
    kept = torch.nonzero((t >= 0) & (t < num_segments))[:, 0]
    if kept.numel() == 0:
        return out
    tk = t[kept]
    st, by_t = torch.sort(tk, stable=True)
    rank = torch.empty_like(st)
    rank[by_t] = (torch.arange(st.numel(), device=st.device)
                  - torch.searchsorted(st, st))
    # rows grouped by their rank in their segment, in ascending row index
    sr, by_rank = torch.sort(rank, stable=True)
    steps = torch.searchsorted(
        sr, torch.arange(int(sr[-1]) + 2, device=sr.device)).tolist()
    src, dst = kept[by_rank], tk[by_rank]
    for a, b in zip(steps[:-1], steps[1:]):
        out.index_add_(0, dst[a:b], rows[src[a:b]])
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
