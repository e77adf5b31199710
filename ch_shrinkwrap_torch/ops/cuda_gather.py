"""K3: the row-gather kernel, the fused gather + masked group sum, and
their plain versions.

``row_gather(src, idx)`` is the port of the JAX package's sliding-ring
gather ``ring_gather`` (``ops/pallas_gather.py:598``): ``src[idx]`` for
an f32 table of at most 16 columns, row-major output.  The TPU kernel
needed a host-built ring schedule; this one reads the index stream
directly, so callers pass plain index arrays.

``row_group_sum(src, idx, care)`` fuses that gather with the masked sum
the faces -> vertices fold runs after it (the JAX package's
``ring_gather`` + XLA sum, ``solver/shrinkwrap.py:500-510``):
``out[v] = sum_k care[v, k] * src[idx[v K + k]]``, summed in the order
k = 0..K-1, without the (V, K, C) intermediate.

On a CUDA tensor each launches its kernel in ``csrc/gather.cu``; on a
CPU tensor it runs its plain version.  Indices outside ``[0, V)`` read
as zero rows.
"""

from __future__ import annotations

import torch

from . import _build

MAX_COLS = 16
MAX_GROUP = 16          # rows row_group_sum sums per output row
INT32_MAX = 2 ** 31 - 1


def _check(src, idx):
    if src.dim() != 2 or not 1 <= src.shape[1] <= MAX_COLS:
        raise ValueError(f'src must be (V, C<={MAX_COLS}), got '
                         f'{tuple(src.shape)}')
    if src.dtype != torch.float32:
        raise TypeError(f'src must be float32, got {src.dtype}')
    if idx.dim() != 1:
        raise ValueError('idx must be 1-D')
    if idx.numel() * src.shape[1] > INT32_MAX or src.shape[0] > INT32_MAX:
        raise ValueError('row_gather indexes with 32-bit integers')


def row_gather(src, idx):
    """``src[idx]`` -> (R, C)."""
    _check(src, idx)
    if src.device.type == 'cpu':
        return row_gather_plain(src, idx)
    src_c = src.contiguous()
    idx_i = idx.int().contiguous()
    _build.require_cuda(src_c, idx_i)
    out = torch.empty((idx_i.shape[0], src.shape[1]), dtype=torch.float32,
                      device=src.device)
    err = _build.lib().csw_row_gather(
        src_c.data_ptr(), src.shape[0], src.shape[1], idx_i.data_ptr(),
        idx_i.shape[0], out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, 'row_gather')
    row_gather.launches += 1
    return out


row_gather.launches = 0


def row_gather_plain(src, idx):
    """Plain PyTorch version of :func:`row_gather`."""
    _check(src, idx)
    i = idx.long()
    ok = (i >= 0) & (i < src.shape[0])
    out = src[i.clamp(0, max(src.shape[0] - 1, 0))]
    return torch.where(ok[:, None], out, torch.zeros_like(out))


def _check_group(src, idx, care):
    _check(src, idx)
    if care.dim() != 2 or care.dtype != torch.bool \
            or not 1 <= care.shape[1] <= MAX_GROUP:
        raise ValueError(f'care must be a (R, K<={MAX_GROUP}) bool mask')
    if idx.numel() != care.numel():
        raise ValueError(f'idx has {idx.numel()} rows, care {care.numel()}')


def row_group_sum(src, idx, care):
    """``sum_k care[:, k, None] * src[idx.reshape(R, K)[:, k]]`` ->
    (R, C)."""
    _check_group(src, idx, care)
    if src.device.type == 'cpu':
        return row_group_sum_plain(src, idx, care)
    src_c = src.contiguous()
    idx_i = idx.int().contiguous()
    care_c = care.contiguous()
    _build.require_cuda(src_c, idx_i, care_c)
    R, K = care.shape
    out = torch.empty((R, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    err = _build.lib().csw_row_group_sum(
        src_c.data_ptr(), src.shape[0], src.shape[1], idx_i.data_ptr(),
        care_c.data_ptr(), K, R, out.data_ptr(), _build.stream_ptr(out))
    _build.check(err, 'row_group_sum')
    row_group_sum.launches += 1
    return out


row_group_sum.launches = 0


def row_group_sum_plain(src, idx, care):
    """Plain PyTorch version of :func:`row_group_sum`: the gather, then
    the masked rows added in the kernel's order, k = 0..K-1 from zero."""
    _check_group(src, idx, care)
    R, K = care.shape
    g = row_gather_plain(src, idx).reshape(R, K, -1)
    out = torch.zeros((R, src.shape[1]), dtype=src.dtype, device=src.device)
    for k in range(K):
        out = torch.where(care[:, k, None], out + g[:, k], out)
    return out
