"""The brute-force nearest-face search kernel and its plain version.

``brute_min`` is the exact search behind
:func:`~ch_shrinkwrap_torch.ops.correspondence.nearest_face_bruteforce`:
each point's nearest valid face centre over every face.  On a CUDA
tensor it launches ``csrc/brute.cu``; on a CPU tensor it runs
``brute_min_plain``.  The JAX package's counterpart is a jitted
``lax.scan``, not a Pallas kernel; this kernel was added for the
evaluation sweep's path, where the plain version's float64 emulation of
each FMA costs about 19,400 kernels a search (19.7k points, 70,656
faces; 0.52 s on an H100 against the kernel's 0.38 ms).

Both round the squared distances as the JAX package's jitted ones are
rounded: ``(p2 + c2) - 2 * dot`` with XLA's FMA chains for ``p2``,
``c2`` and ``dot`` (``BIG`` for ``c2`` on a masked face), and both take
the lexicographic minimum of ``(d2, face id)`` from the sentinel
``(BIG, 0)``, so kernel, plain version and the JAX package agree bit for
bit, ids included.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# the grid's face splits are chosen so that about this many waves of
# blocks fill the card, each split at least MIN_SPLIT_TILES staged tiles;
# at the sweep's shape on an H100 every choice from 6 to 69 splits took
# 0.41-0.45 ms, and this one (21 splits) the least
WAVES = 4
MIN_SPLIT_TILES = 2


def _check(points, centers, f_mask):
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f'points must be (N, 3), got {tuple(points.shape)}')
    if centers.dim() != 2 or centers.shape[1] != 3:
        raise ValueError(f'centers must be (Fp, 3), got '
                         f'{tuple(centers.shape)}')
    if tuple(f_mask.shape) != (centers.shape[0],):
        raise ValueError(f'f_mask must be ({centers.shape[0]},), got '
                         f'{tuple(f_mask.shape)}')
    if not points.device == centers.device == f_mask.device:
        raise ValueError(f'points, centers and f_mask must share one '
                         f'device, got {points.device}, {centers.device} '
                         f'and {f_mask.device}')


def splits(n_points, n_faces, n_sms):
    """Face splits of the kernel's grid for ``n_points`` points and
    ``n_faces`` faces on a card of ``n_sms`` SMs: enough blocks for
    :data:`WAVES` waves, no split below :data:`MIN_SPLIT_TILES` tiles."""
    pb, tile, _, _, per_sm = schedule()
    tiles = -(-n_points // pb)
    want = -(-WAVES * n_sms * per_sm // max(tiles, 1))
    most = max(n_faces // (MIN_SPLIT_TILES * tile), 1)
    return max(1, min(want, most))


def schedule():
    """The kernel's schedule, as the built ``csrc/brute.cu`` reports it:
    ``(points, tile, group_span, chunk, per_sm)``, the points of a
    block, the faces staged at a time, a thread group's span of a tile,
    the candidates of one chunk of the argmin and the blocks an SM
    holds.  The tie tests place ties on its seams.  Needs the kernel
    library, so the CUDA toolkit."""
    out = [ctypes.c_int() for _ in range(5)]
    _build.lib().csw_brute_schedule(*(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def brute_min(points, centers, f_mask, face_chunk=4096, point_block=1024):
    """Exact nearest valid face centre of each point: (dist (N,) f32,
    idx (N,) i32).

    points : (N, 3) f32
    centers : (Fp, 3) f32 — face centres
    f_mask : (Fp,) — valid faces
    ``face_chunk`` and ``point_block`` shape the plain version's
    temporaries only.  Ties go to the lowest face id; with no valid face
    a point gets (sqrt(BIG), 0).
    """
    _check(points, centers, f_mask)
    if points.device.type == 'cpu':
        return brute_min_plain(points, centers, f_mask, face_chunk,
                               point_block)
    for t in (points, centers):
        if t.dtype != torch.float32:
            raise TypeError(f'expected float32, got {t.dtype}')
    N, Fp = points.shape[0], centers.shape[0]
    dev = points.device
    pts = points.contiguous()
    cen = centers.contiguous()
    mask = f_mask.bool().contiguous().view(torch.uint8)
    L = _build.lib()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split = splits(N, Fp, n_sms)
    table = torch.empty((Fp, 4), dtype=torch.float32, device=dev)
    part = torch.empty((L.csw_brute_splits(Fp, n_split), N),
                       dtype=torch.int64, device=dev)
    dist = torch.empty((N,), dtype=torch.float32, device=dev)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    _build.require_cuda(pts, cen, mask, table, part, dist, idx)
    err = L.csw_brute_min(
        pts.data_ptr(), cen.data_ptr(), mask.data_ptr(), N, Fp, n_split,
        table.data_ptr(), part.data_ptr(), dist.data_ptr(), idx.data_ptr(),
        _build.stream_ptr(pts))
    _build.check(err, 'brute_min')
    brute_min.launches += 1
    return dist, idx


brute_min.launches = 0


def brute_min_plain(points, centers, f_mask, face_chunk=4096,
                    point_block=1024):
    """Plain PyTorch version of :func:`brute_min`: streamed over point
    blocks x face chunks with a running (min, argmin) merge, the squared
    distances rounded as the JAX package's jitted ones are (XLA's FMA
    chains, through ``sumsq3`` and ``_dot3``), ``torch.min`` (first
    index on ties) within a chunk and strict ``<`` across chunks; the
    float64 temporaries of ``fma_f32`` are why the point blocks are
    small."""
    # correspondence imports this module; its helpers are read at call
    from .correspondence import BIG, _dot3, _masked_c2, sumsq3
    _check(points, centers, f_mask)
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
