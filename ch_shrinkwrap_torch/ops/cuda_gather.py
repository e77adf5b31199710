"""K3: the row-gather kernel and its plain version.

``row_gather(src, idx)`` is the port of the JAX package's sliding-ring
gather ``ring_gather`` (``ops/pallas_gather.py:598``): ``src[idx]`` for
an f32 table of at most 16 columns, row-major output.  The TPU kernel
needed a host-built ring schedule; this one reads the index stream
directly, so callers pass plain index arrays.  On a CUDA tensor it
launches ``csrc/gather.cu``; on a CPU tensor it runs
``row_gather_plain``.  Indices outside ``[0, V)`` give zero rows.
"""

from __future__ import annotations

import torch

from . import _build

MAX_COLS = 16


def _check(src, idx):
    if src.dim() != 2 or not 1 <= src.shape[1] <= MAX_COLS:
        raise ValueError(f'src must be (V, C<={MAX_COLS}), got '
                         f'{tuple(src.shape)}')
    if src.dtype != torch.float32:
        raise TypeError(f'src must be float32, got {src.dtype}')
    if idx.dim() != 1:
        raise ValueError('idx must be 1-D')


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
    L = _build.lib()
    err = L.csw_row_gather(src_c.data_ptr(), src.shape[0], src.shape[1],
                           idx_i.data_ptr(), idx_i.shape[0],
                           out.data_ptr(), _build.stream_ptr(out))
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
