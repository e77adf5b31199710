"""PyTorch port, the image recipe as the benchmark's ``image5nm.recipe``
cell runs it, at a size the CPU holds: a 4 nm histogram of 3000
localizations on an R = 60 nm sphere, so the voxel counts, and with them
the residual weights, vary.

* The rows the recipe hands to ``shrink_wrap`` (pseudo-localizations,
  inverse errors, weights) are the benchmark's own plain copy in
  ``benchmark/fits/image.py``, row for row, and the residual weights the
  fit's blocks get are that copy's ``weights``.
* One CG block with the shrink prior on and lattice weights, through the
  port's plain versions, against the benchmark's float64 reference.
* The recipe's spans: ``recipe`` with ``recipe/repair``,
  ``recipe/remesh`` and ``recipe/pseudo_points``, closed before the fit
  opens ``prep``; the image's counts on ``recipe/pseudo_points``; each
  ``cg_block`` record's ``shrink`` and ``directions``; ``recipe_s``.
"""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.fits import image as bench_image
from benchmark.instrument import Spans
from benchmark.reference import cg_block as ref
from ch_shrinkwrap_torch.models import membrane_mesh as mm

torch.set_num_threads(1)

with open(os.path.join(harness.ROOT, 'benchmark', 'configs',
                       'image5nm.json')) as _fh:
    CELL_CONFIG = json.load(_fh)
CONFIG = dict(CELL_CONFIG,
              cloud={'shape': 'sphere', 'n_points': 3000, 'radius': 60.0,
                     'sigma': 5.0},
              voxel_nm=4.0, seed={'offset': 25.0, 'grid_n': 12},
              minimum_edge_length=8.0, correspondence='brute')
WORKLOAD = {'iterations': 12, 'remesh_frequency': 5, 'punch_frequency': 0,
            'min_hole_radius': 100.0, 'neck_first_iter': 9}
SEED = 3_000_000_019
# the block check's bound at the tiny benchmark size
# (benchmark/tests/bench_tiny.py's block_gap)
BLOCK_GAP = 1e-3


def make_fit():
    return bench_image.Fit(CONFIG, WORKLOAD, SEED, 'cpu', Spans())


def _rows_key(a):
    return np.lexsort((a[:, 2], a[:, 1], a[:, 0]))


def test_recipe_rows_are_the_benchmark_copy(monkeypatch):
    """What the recipe hands to ``shrink_wrap``, and what the fit's first
    block gets, against ``fits/image.py``'s plain copy: equal, exactly."""
    fit = make_fit()
    handed, blocks = {}, []
    orig_wrap, orig_block = mm.MembraneMesh.shrink_wrap, mm.block_call

    def shrink_wrap(self, points=None, sigma=None, weights=None, **kw):
        handed.update(points=points, sigma=sigma, weights=weights)
        return orig_wrap(self, points, sigma, weights=weights, **kw)

    def block_call(*a, **k):
        blocks.append(a)
        return orig_block(*a, **k)
    monkeypatch.setattr(mm.MembraneMesh, 'shrink_wrap', shrink_wrap)
    monkeypatch.setattr(mm, 'block_call', block_call)
    fit(max_iter=1)
    inp = fit.inputs
    counts = np.asarray(fit.image.data)
    n = int((counts > 0).sum())
    assert n > 1000 and counts.max() > 1      # the weights vary
    pts = np.asarray(handed['points'])
    assert pts.dtype == np.float64 and pts.shape == (n, 3)
    rows, c = bench_image.pseudo_localizations(fit.image)
    np.testing.assert_array_equal(pts, rows)
    np.testing.assert_array_equal(pts.astype(np.float32), inp['points'])
    np.testing.assert_array_equal(
        np.full((n, 3), 1.0 / handed['sigma']), inp['sigma_inv'])
    np.testing.assert_array_equal(
        handed['weights'], np.repeat(inp['counts'], 3).reshape(-1, 3))
    np.testing.assert_array_equal(inp['counts'], c)
    assert float(inp['counts'].sum()) == float(counts.sum()) == 3000.0
    # the block's cloud is in the fit's order: the same rows, each with
    # the copy's residual weight and inverse error
    b = blocks[0]
    P, sig, W = (t.numpy() for t in b[5:8])
    ip, ix = _rows_key(P), _rows_key(inp['points'])
    np.testing.assert_array_equal(P[ip], inp['points'][ix])
    np.testing.assert_array_equal(W[ip], inp['weights'][ix])
    np.testing.assert_array_equal(sig[ip],
                                  inp['sigma_inv'][ix].astype(np.float32))


def _block_gap(got, f_ref, start, v_mask):
    vm = v_mask.bool()

    def rms(x):
        return float(torch.sqrt((x.double() ** 2).sum(1).mean()))
    return rms((got.double() - f_ref)[vm]) / rms(
        (f_ref - start.double())[vm])


def test_shrink_block_against_the_reference(monkeypatch):
    """The second CG block of the tiny image fit (after the first
    remesh), through the port's plain versions in float32, against
    ``benchmark/reference/cg_block.cg_block`` in float64 with the shrink
    prior on.  The two differ by float32 rounding alone, carried
    through five iterations; on a lattice more points sit near a tie
    between two faces, where the rounding can pick the other face, so
    the gap reads 7.3e-5 of the block's step here (about 1e-6 on the
    points cell's cloud).  ``bench_tiny``'s block_gap bound of 1e-3
    holds with more than ten times that room, and bfloat16's 8-bit
    mantissa puts the same reference at 0.12, over ten times the
    bound."""
    fit = make_fit()
    calls = []
    orig = mm.block_call

    def block_call(*a, **k):
        out = orig(*a, **k)
        calls.append((a, k, out[0]))
        return out
    monkeypatch.setattr(mm, 'block_call', block_call)
    fit(max_iter=10)
    a, k, got = calls[1]
    assert k['use_shrink'] and a[10] == 1.0          # shrink_lam
    (positions, faces, f_mask, v_mask, _, pts, sig, w, pmask, lam0,
     shrink_lam) = a
    assert float(w.min()) != float(w.max())          # lattice weights
    args = (positions, faces, f_mask, v_mask, pts, sig, w, pmask, lam0,
            shrink_lam, k['num_iters'], k['active_iters'], True,
            CONFIG['correspondence'])
    f64 = ref.cg_block(*args, dtype=torch.float64)
    gap = _block_gap(got, f64, positions, v_mask)
    assert gap < BLOCK_GAP, gap
    bf16 = ref.cg_block(*args, dtype=torch.bfloat16)
    assert _block_gap(bf16, f64, positions, v_mask) > 10 * BLOCK_GAP


def test_recipe_spans_counters_and_reader():
    fit = make_fit()
    mesh = fit(max_iter=10)
    recs = mesh.trace.records
    by = {}
    for r in recs:
        by.setdefault(r.kind, []).append(r)
    (top,) = by['recipe']
    assert top.parent is None
    for child in ('repair', 'remesh', 'pseudo_points'):
        (r,) = by['recipe/' + child]
        assert r.parent is top
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
    assert by['recipe/remesh/engine'][0].parent is by['recipe/remesh'][0]
    # siblings of the fit's spans, closed before the fit opens its own;
    # the fit's kinds keep the names the points cells have
    (prep,) = by['prep']
    assert prep.parent is None and top.end_ns <= prep.start_ns
    assert not any(r.kind.startswith('recipe/') and r.kind.split('/')[1]
                   in ('prep', 'cg_block', 'remove_necks', 'short_edges')
                   for r in recs)
    assert len(by['cg_block']) == 2 and 'remesh' in by \
        and 'remove_necks' in by
    data = np.asarray(fit.image.data)
    extra = by['recipe/pseudo_points'][0].extra
    assert extra == dict(voxels=int(data.size),
                         n_pseudo=int((data > 0).sum()),
                         weight_sum=float(data.sum()))
    assert extra['weight_sum'] == 3000.0
    for r in by['cg_block']:
        assert r.extra['shrink'] is True and r.extra['directions'] == 4
    run = harness.Run(None, 0.0)
    run.fits = [harness.fit_record(1.0, {}, mesh)]
    got = harness.metric_module('recipe_s').read(run)
    assert got == pytest.approx(top.wall_time, rel=1e-12) and got > 0
