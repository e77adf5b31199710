"""Host-side spatial orderings shared by the mesh and the fit loop.

The Hilbert and Morton sort keys that make vertex, face and point
indices spatially local (the Hilbert codes from the native host
engine), the once-per-fit point permutation, and the stratified face
subsample of the windowed correspondence search.
Counterpart of the same functions in the JAX package's
``ops/correspondence.py:106-391``.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _subsample_ids(n_total, n_sub):
    """Quasi-uniform face subsample: stratified + hash-jittered.

    A plain stride aliases with structured face orderings (e.g. the
    4-block interleaving of subdivision meshes) and can skip whole
    regions.  Pure Knuth multiplicative hashing (``i * 2654435761
    % n_total``) decorrelates from the ordering but equidistributes
    POORLY for unlucky ``n_total``: at the 263168-face capacity the
    1024 hashed ids left gaps of ~1500 consecutive faces (vs ~280 at
    187392), which collapsed the windowed search's far-point fallback
    — measured 0.92 nearest-face agreement vs 0.98 at neighboring
    capacities, and a 99-iter fit at that capacity wrinkled hard
    enough to shred in the neck pass.  One jittered sample per
    ``n_total / n_sub`` stratum keeps the worst gap below two strata
    for EVERY capacity while the in-stratum hash keeps the
    decorrelation.
    """
    n_sub = min(n_sub, n_total)
    i = np.arange(n_sub, dtype=np.uint64)
    base = i * np.uint64(n_total) // np.uint64(n_sub)
    strat = max(n_total // n_sub, 1)
    # jitter from the HIGH bits of the multiplicative hash: the low
    # bits of i * K mod a small stratum correlate with i (K mod strat
    # can be 1), which would leave the jitter a deterministic ramp
    jit = ((i * np.uint64(2654435761)) >> np.uint64(17)) \
        % np.uint64(strat)
    ids = np.minimum(base + jit, np.uint64(n_total - 1))
    return np.unique(ids.astype(np.int32))


def morton_order(points, bits=10):
    """Host-side Morton (Z-order) sort permutation for a point cloud."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(0)
    hi = p.max(0)
    q = ((p - lo) / np.maximum(hi - lo, 1e-12) * ((1 << bits) - 1)
         ).astype(np.uint64)

    def spread(x):
        x &= (1 << bits) - 1
        x = (x | (x << 32)) & 0x1f00000000ffff
        x = (x | (x << 16)) & 0x1f0000ff0000ff
        x = (x | (x << 8)) & 0x100f00f00f00f00f
        x = (x | (x << 4)) & 0x10c30c30c30c30c3
        x = (x | (x << 2)) & 0x1249249249249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return np.argsort(code, kind='stable')


def hilbert_order(points, bits=10):
    """Host-side Hilbert-curve sort permutation (Skilling transpose).

    Unlike the Morton curve, the Hilbert curve has no octant jumps:
    consecutive-index runs are spatially CONNECTED patches, which is
    what the blocked search's per-block candidate sets rely on.
    """
    return np.argsort(hilbert_codes_for(points, bits), kind='stable')


def hilbert_codes_for(points, bits=10, lo=None, hi=None):
    """uint64 Hilbert codes of the points, quantized over their own
    bounding box (the sort key behind :func:`hilbert_order`, exposed
    so callers can combine it with partition flags into ONE argsort —
    fit_point_order's two per-partition sorts cost ~0.7 s/fit at 1e6
    points on this 1-core host).  ``lo``/``hi`` override the
    quantization box (points outside clip): fit_point_order passes the
    dense partition's box so sparse background outliers don't coarsen
    the surface points' quantization."""
    p = np.asarray(points, dtype=np.float64)
    if lo is None:
        lo = p.min(0)
    if hi is None:
        hi = p.max(0)
    p = np.clip(p, lo, hi)
    X = ((p - lo) / np.maximum(hi - lo, 1e-12) * ((1 << bits) - 1)
         ).astype(np.uint32)
    return native.hilbert_codes(X, bits)


def fit_point_order(points, grid_n=128, sparse_fraction=0.1):
    """Once-per-fit point permutation for the blocked search.

    Hilbert order alone lets sparse background-noise points drag a
    block across huge empty volumes (the curve visits them between
    surface patches), wrecking that block's candidate coverage for the
    surface points caught inside.  Partition by local density first,
    Hilbert-sort each part, and put the sparse part last: dense blocks
    stay spatially tight, sparse blocks hold only noise points whose
    far matches tolerate the subsample fallback's bounded error.

    Density is a grid-cell occupancy count (a kNN radius estimate costs
    ~14 s at 1e6 points on this host; the histogram costs ~0.3 s and
    partitions equivalently for this purpose).
    """

    points = np.asarray(points)
    lo = points.min(0)
    hi = points.max(0)
    h = float((hi - lo).max()) / grid_n
    if h <= 0:
        return hilbert_order(points).astype(np.int64)
    cells = np.floor((points - lo) / h).astype(np.int64)
    key = (cells[:, 0] * (grid_n + 2) + cells[:, 1]) * (grid_n + 2) \
        + cells[:, 2]
    uniq, inv, counts = np.unique(key, return_inverse=True,
                                  return_counts=True)
    occupancy = counts[inv]
    thresh = max(2.0, sparse_fraction * float(np.median(counts)))
    sparse = occupancy < thresh
    # ONE argsort over (sparse flag, hilbert code): dense points first
    # in curve order, then sparse, exactly as the old two-partition
    # construction but without the second full sort (1.10 -> ~0.55 s
    # at 1e6 points).  Each partition keeps its OWN quantization box
    # (the old behavior): one shared box measurably hurts — global box
    # coarsens the surface points' quantization under far background
    # outliers, and clipping sparse points to the dense box destroys
    # their depth ordering (windowed-id agreement 0.981 -> 0.978 on
    # the production-shape test either way).
    dense_pts = points[~sparse] if sparse.any() and not sparse.all() \
        else points
    codes = hilbert_codes_for(points, lo=dense_pts.min(0),
                              hi=dense_pts.max(0))
    if sparse.any():
        sp = points[sparse]
        codes[sparse] = hilbert_codes_for(sp)
    key = codes | (sparse.astype(np.uint64) << np.uint64(62))
    return np.argsort(key, kind='stable').astype(np.int64)
