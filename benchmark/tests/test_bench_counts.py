"""The frozen bound arithmetic at the shapes PERF.md gives."""

import pytest

from benchmark.counts import bounds


def test_k1_count_at_the_north_star_shapes():
    nb = -(-1_000_000 // 256)
    pairs = bounds.k1_pairs(nb, 256, 3, 2048, 1024)
    assert pairs == 7_169_376_256      # 7.17e9
    s, by = bounds.k1_bound(nb, 256, 3, 2048, 1024, 186_368)
    assert by == 'operations'
    assert s * 1e3 == pytest.approx(0.749, abs=5e-4)


def test_gather_and_k2_bounds_are_bytes_over_the_hbm_rate():
    s, by = bounds.gather_bound(3.35e9, 0)
    assert (s, by) == (pytest.approx(1e-3), 'bytes')
    s, by = bounds.k2_bound(1_000_000, 32_000_000, 100_000, 12)
    assert by == 'bytes'
    assert s == pytest.approx((32e6 + 4.8e6) / 3.35e12)


def test_k2s_bound_is_rows_in_and_segments_out_over_the_hbm_rate():
    # the normals' corner rows (3 Fp, 3) f32 and their int32 targets onto
    # Vp vertices, 3 columns: chip_smoke's rule for PERF.md's K2s row
    Fp, Vp = 200_000, 100_002
    s, by = bounds.k2s_bound(3 * Fp * (12 + 4), Vp, 3)
    assert by == 'bytes'
    assert s == pytest.approx((48 * Fp + 12 * Vp) / 3.35e12)
