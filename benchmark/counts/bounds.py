"""Least device time of the fit's kernels, from what their inputs need.

Frozen from ``chip_smoke.py`` (``bound_ms`` and the kernels phase's
byte and operation counts).  The counts come from the shapes of each
call's arguments and results, never from how a kernel is written, so a
later kernel change cannot make them stale:

* K1, the windowed nearest-face search: 7 FP32 operations (3 multiplies,
  3 adds, 1 min) for every point-face pair the search as defined
  examines, 256-point blocks x (A windows of W faces + the subsample),
  at the FP32 peak; its bytes are the blocks, starts, subsample ids,
  results and a 16-byte face row read once.
* K2, the windowed A^T segment sum: the per-point rows read once and the
  face sums written once, at the HBM rate (24 operations a point).
* K2s, the ordered segment sum on its own (``segment_sum_ordered``):
  the rows, their targets (and an initial table) read once and the
  segments written once, at the HBM rate: K2's rule.
* K3 / K3f, the row gathers: the table, the index stream (and mask) read
  once and the gathered rows written once, at the HBM rate.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
K1_OPS_PER_PAIR = 7.0
K2_OPS_PER_ROW = 24.0


def bound_s(n_bytes, n_flops):
    """(seconds, 'bytes' | 'operations'): the larger of the bytes over
    the HBM rate and the FP32 operations over the FP32 peak."""
    tb = n_bytes / HBM_BYTES_PER_S
    tf = n_flops / FP32_FLOPS_PER_S
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def k1_pairs(n_blocks, block, n_anchors, window, n_sub):
    """Point-face pairs the windowed search examines."""
    return n_blocks * block * (n_anchors * window + n_sub)


def k1_bound(n_blocks, block, n_anchors, window, n_sub, face_rows):
    """K1's bound for one call; ``face_rows`` is the 128-aligned face
    table length."""
    pairs = k1_pairs(n_blocks, block, n_anchors, window, n_sub)
    n_bytes = (4 * 3 * n_blocks * block        # point blocks
               + 4 * n_blocks * n_anchors      # window starts
               + 4 * n_sub                     # subsample ids
               + 3 * 4 * n_blocks * block      # d2, face id, slot
               + 16 * (face_rows + n_sub))     # face rows read once
    return bound_s(n_bytes, K1_OPS_PER_PAIR * pairs)


def k2_bound(n_points, in_bytes, num_segments, out_cols):
    """K2's bound for one call: ``in_bytes`` of per-point rows and
    routing read once, ``num_segments`` x ``out_cols`` f32 face sums
    written once."""
    return bound_s(in_bytes + 4 * num_segments * out_cols,
                   K2_OPS_PER_ROW * n_points)


def k2s_bound(in_bytes, num_segments, cols):
    """K2s's bound for one call: ``in_bytes`` of rows, targets and
    initial table read once, ``num_segments`` x ``cols`` f32 segments
    written once."""
    return bound_s(in_bytes + 4 * num_segments * cols, 0.0)


def gather_bound(in_bytes, out_bytes):
    """K3's or K3f's bound for one call."""
    return bound_s(in_bytes + out_bytes, 0.0)
