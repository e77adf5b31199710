"""The seed's density field on the card, and its plain version.

``knn_field(points, queries, k, bound)`` has the contract of the host
engine's ``native.knn_field``: (Q,) float32, for each query the distance
to its k-th nearest point among the points within ``bound`` of it, or
``2*bound`` where fewer than k lie within (the whole field, where there
are fewer than k points, k < 1 or bound <= 0).  ``points`` (N, 3) and
``queries`` (Q, 3) are float32 tensors on one device; ``bound`` is
rounded to float32, as the host engine takes it.  On a CUDA tensor it
launches ``csrc/knn_field.cu``; on a CPU tensor it runs
``knn_field_plain``.  Both return the host engine's bits where g++
builds it with ``-march=native`` for a CPU with FMA: the k-th smallest
of a set is one value, and each squared distance is the FMA chain that
g++ then contracts the engine's sum into, ``fma(dz, dz, fma(dx, dx,
dy*dy))``.  The engine's fallback build (plain ``-O3``, where
``-march=native`` fails) rounds the sum unfused and may differ in the
last bit; ``chip_smoke.py``'s kernels phase compares the two bit for
bit on each host it runs on.

``live``, where given, is a (Q,) bool tensor on the queries' device that
receives the queries that reach the search: those with at least k points
in the cube of grid cells around their own that holds their ball of
radius ``bound`` (``reaches_search``, the kernel's rejection alone).
The others are ``2*bound`` without one.

The grid (``field_grid``) has cells of about bound/4, so a live query
walks a few hundred points at its first radius; the answer does not
depend on the grid, only the work does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import _build, cuda_scatter
from ..utils.math import fma_f32

STEPS = 4               # the kernel's search radii, bound * j / STEPS
MAX_CELLS = 1 << 21     # cells of the grid at most
PLAIN_QUERIES = 256     # live queries the plain version boxes together
PLAIN_PAIRS = 1 << 21   # query-point pairs it holds at once
INT32_MAX = 2 ** 31 - 1


class FieldGrid(NamedTuple):
    lo: tuple       # the points' lowest corner (float32 values)
    c: float        # the cell's edge (a float32 value)
    dims: tuple     # cells along each axis
    nblock: int     # cells each way of a query's cell that hold its ball
    margin: float   # what a radius walked exceeds its threshold's root by


def field_grid(lo, hi, bound):
    """The cell grid over points spanning the float32 corners ``lo`` and
    ``hi``, for a float32 ``bound`` > 0: cells of bound * (1 + 1/64) / 4,
    coarser where that would make more than ``MAX_CELLS``.  ``margin``
    covers every rounding of a point's or a query's cell and of a
    radius; ``nblock`` cells each way of a query's cell hold every point
    within ``bound`` of it."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    ext = hi.astype(np.float64) - lo.astype(np.float64)
    scale = float(max(np.abs(lo).max(), np.abs(hi).max()))
    c = max(bound * (1.0 + 1.0 / 64) / STEPS, 2.0 ** -100)
    while True:
        c32 = float(np.float32(c))
        dims = tuple(int(e // c32) + 1 for e in ext)
        n = dims[0] * dims[1] * dims[2]
        if n <= MAX_CELLS:
            break
        c = c32 * max((n / MAX_CELLS) ** (1.0 / 3.0), 1.01)
    margin = float(np.float32(c32 / 64 + (scale + bound) * 2.0 ** -18))
    nblock = math.ceil((bound * (1.0 + 2.0 ** -15) + 2.0 * margin) / c32)
    return FieldGrid(tuple(float(v) for v in lo), c32, dims, nblock, margin)


def _bound32(bound):
    b = float(np.float32(bound))
    if not math.isfinite(b):
        raise ValueError(f'bound must be finite, got {bound}')
    return b


def _all_miss(N, k, b):
    """The host engine's cases with no search at all."""
    return N < k or k < 1 or not b > 0


def _check(points, queries, live):
    for name, t in (('points', points), ('queries', queries)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f'{name} must be (n, 3), got {tuple(t.shape)}')
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
    if queries.device != points.device:
        raise ValueError(f'points on {points.device}, queries on '
                         f'{queries.device}')
    if live is not None and (live.shape != (queries.shape[0],)
                             or live.dtype != torch.bool
                             or live.device != queries.device):
        raise ValueError('live must be a (Q,) bool tensor on the queries\' '
                         'device')
    if points.shape[0] > INT32_MAX - cuda_scatter.RADIX_TILE \
            or queries.shape[0] > INT32_MAX:
        raise ValueError('the field indexes with 32-bit integers')


def knn_field(points, queries, k, bound, live=None):
    """(Q,) float32 bounded k-th-NN distances (the module's contract)."""
    _check(points, queries, live)
    if points.device.type == 'cpu':
        return knn_field_plain(points, queries, k, bound, live)
    _build.require_cuda(points, queries,
                        *(() if live is None else (live,)))
    b = _bound32(bound)
    N, Q = points.shape[0], queries.shape[0]
    out = torch.empty(Q, dtype=torch.float32, device=queries.device)
    if _all_miss(N, int(k), b):
        out.fill_(2.0 * b)
        if live is not None:
            live.zero_()
        return out
    lo, hi = torch.aminmax(points, dim=0)
    corners = torch.stack([lo, hi]).cpu().numpy()
    g = field_grid(corners[0], corners[1], b)
    L, s = _build.lib(), _build.stream_ptr(out)
    cell = torch.empty(N, dtype=torch.int32, device=points.device)
    _build.check(L.csw_knn_bin(points.data_ptr(), N, *g.lo, g.c, *g.dims,
                               cell.data_ptr(), s), 'knn_bin')
    perm, offsets = cuda_scatter.radix_order(cell, math.prod(g.dims))
    pts4 = torch.empty((N, 4), dtype=torch.float32, device=points.device)
    _build.check(L.csw_knn_gather(points.data_ptr(), perm.data_ptr(), N,
                                  pts4.data_ptr(), s), 'knn_gather')
    _build.check(L.csw_knn_field(
        pts4.data_ptr(), offsets.data_ptr(), *g.lo, g.c, *g.dims, g.nblock,
        g.margin, queries.data_ptr(), Q, int(k), b, out.data_ptr(),
        None if live is None else live.data_ptr(), s), 'knn_field')
    knn_field.launches += 1
    return out


knn_field.launches = 0


def reaches_search(points, queries, k, bound):
    """(Q,) bool: the queries with at least k points in the cube of
    ``nblock`` cells each way of their own cell (the kernel's rejection,
    in plain torch on the points' device)."""
    b = _bound32(bound)
    N, Q = points.shape[0], queries.shape[0]
    dev = queries.device
    if _all_miss(N, int(k), b):
        return torch.zeros(Q, dtype=torch.bool, device=dev)
    lo, hi = torch.aminmax(points, dim=0)
    g = field_grid(lo.cpu().numpy(), hi.cpu().numpy(), b)
    c = torch.tensor(g.c, dtype=torch.float32, device=dev)
    dims = torch.tensor(g.dims, device=dev)
    pc = torch.clamp(torch.floor((points - lo) / c), min=torch.zeros_like(lo),
                     max=(dims - 1).float()).long()
    nx, ny, nz = g.dims
    cid = (pc[:, 0] * ny + pc[:, 1]) * nz + pc[:, 2]
    counts = torch.bincount(cid, minlength=nx * ny * nz).view(nx, ny, nz)
    S = torch.zeros((nx + 1, ny + 1, nz + 1), dtype=torch.int64,
                    device=dev)
    S[1:, 1:, 1:] = counts.cumsum(0).cumsum(1).cumsum(2)
    S = S.view(-1)
    nb = g.nblock
    qc = torch.clamp(torch.floor((queries - lo) / c),
                     min=torch.full_like(lo, -(nb + 1)),
                     max=(dims + nb).float()).long()
    a = torch.clamp(qc - nb, min=0)               # first cell of the cube
    e = torch.minimum(qc + nb, dims - 1) + 1      # past its last: a <= e

    def at(x, y, z):
        return S[(x * (ny + 1) + y) * (nz + 1) + z]

    ax, ay, az = a.unbind(1)
    ex, ey, ez = e.unbind(1)
    count = (at(ex, ey, ez) - at(ax, ey, ez) - at(ex, ay, ez)
             - at(ex, ey, az) + at(ax, ay, ez) + at(ax, ey, az)
             + at(ex, ay, az) - at(ax, ay, az))
    return count >= int(k)


def knn_field_plain(points, queries, k, bound, live=None):
    """Plain PyTorch version of :func:`knn_field`: the kernel's rejection,
    then for each live query the squared distance of every point near
    it (the FMA chain rounded once a step, ``fma_f32``), those beyond
    ``bound`` set aside, the k-th smallest and its correctly rounded
    root.  Live queries go ``PLAIN_QUERIES`` at a time, each group
    against the points in its box widened past ``bound``, at most
    ``PLAIN_PAIRS`` query-point pairs at once."""
    _check(points, queries, live)
    b = _bound32(bound)
    Q = queries.shape[0]
    out = torch.full((Q,), 2.0 * b, dtype=torch.float32,
                     device=queries.device)
    reach = reaches_search(points, queries, k, bound)
    if live is not None:
        live.copy_(reach)
    idx = torch.nonzero(reach).flatten()
    if idx.numel() == 0:
        return out
    bt = torch.tensor(b, dtype=torch.float32, device=queries.device)
    b2 = bt * bt
    inf = torch.tensor(float('inf'), device=queries.device)
    # a point farther than bound * (1 + 2**-10) from a query along one
    # axis has a float32 d2 above bound*bound: every rounding of d2 and
    # of the box is well inside the widening
    scale = max(float(points.abs().max()), float(queries[idx].abs().max()))
    pad = b * (1.0 + 2.0 ** -10) + scale * 2.0 ** -20
    for s in range(0, idx.numel(), PLAIN_QUERIES):
        group = idx[s:s + PLAIN_QUERIES]
        qs = queries[group]
        near = ((points >= qs.min(0).values - pad)
                & (points <= qs.max(0).values + pad)).all(1)
        cand = points[near]
        if cand.shape[0] < int(k):
            continue
        step = max(1, PLAIN_PAIRS // cand.shape[0])
        for t in range(0, group.numel(), step):
            qi = group[t:t + step]
            d = queries[qi, None, :] - cand[None, :, :]
            dx, dy, dz = d.unbind(2)
            d2 = fma_f32(dz, dz, fma_f32(dx, dx, dy * dy))
            kth = torch.where(d2 <= b2, d2, inf).kthvalue(int(k), 1).values
            # torch's float32 sqrt need not round correctly; the float64
            # root of a float32 value, rounded to float32, does
            root = torch.sqrt(kth.double()).float()
            out[qi] = torch.where(kth <= b2, root, out[qi])
    return out
