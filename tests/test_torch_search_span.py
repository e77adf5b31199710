"""PyTorch port, the nearest-face search's span: every iteration of a
CG block that runs the search closes a ``cg_block/block/search`` record
with the method, the points and the padded faces it scanned and its
route (``'plain'`` on the CPU), on the brute-force and the windowed
paths, and handing the trace to the solver changes no bit of the fit.
A diagnostic search outside the loop closes a ``search`` record of its
own.

Small sphere fits on the CPU: 600 localizations, a remesh every 3
iterations, 7 iterations (blocks of 3, 3 and 1).
"""

import numpy as np
import pytest
import torch

from ch_shrinkwrap_torch.mesh.marching import wrap_start
from ch_shrinkwrap_torch.models import MembraneMesh
from ch_shrinkwrap_torch.models import membrane_mesh as mm

torch.set_num_threads(1)

N_POINTS = 600


def _cloud(n=N_POINTS, R=50.0, sigma=5.0, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * R + rng.normal(scale=sigma, size=(n, 3))).astype(np.float32)
    return pts, np.full((n, 3), sigma, np.float32)


def _fit(corr_method):
    pts, sig = _cloud()
    mesh = MembraneMesh(mesh=wrap_start(pts, offset=25.0, grid_n=12),
                        kc=1.0, step_size=20.0, max_iter=7,
                        remesh_frequency=3, corr_method=corr_method,
                        device='cpu')
    mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                     minimum_edge_length=8.0)
    return mesh, pts


@pytest.mark.parametrize('corr_method,method', [('auto', 'brute'),
                                                ('windowed', 'windowed')])
def test_one_search_span_per_active_iteration(corr_method, method):
    mesh, _ = _fit(corr_method)
    assert mesh._last_corr_method == method
    recs = mesh.trace.records
    blocks = [r for r in recs if r.kind == 'cg_block']
    assert [r.extra['n_iters'] for r in blocks] == [3, 3, 1]
    for blk in blocks:
        call = [r for r in recs if r.parent is blk
                and r.kind == 'cg_block/block']
        assert len(call) == 1
        searches = [r for r in recs if r.parent is call[0]]
        # no block of these fits stops early: every active iteration
        # searched
        assert np.isfinite(blk.tests[:blk.extra['n_iters']]).all()
        assert len(searches) == blk.extra['n_iters']
        # the padded faces of the block's arrays, the same in each
        n_faces = {r.extra['n_faces'] for r in searches}
        assert len(n_faces) == 1 and n_faces.pop() >= blk.n_faces
        for r in searches:
            assert r.kind == 'cg_block/block/search'
            assert r.extra == dict(method=method, n_points=N_POINTS,
                                   n_faces=r.extra['n_faces'],
                                   route='plain')
            assert call[0].start_ns <= r.start_ns <= r.end_ns \
                <= call[0].end_ns
    n_search = sum(r.kind == 'cg_block/block/search' for r in recs)
    assert n_search == 7


def test_trace_in_the_solver_changes_no_bit(monkeypatch):
    """The fit with the trace handed to the solver against the same fit
    with the solver given none: the same vertices, bit for bit, and no
    search record in the second."""
    traced, pts = _fit('auto')
    orig = mm.block_call

    def untraced(*a, **k):
        k['trace'] = None
        return orig(*a, **k)
    monkeypatch.setattr(mm, 'block_call', untraced)
    plain, _ = _fit('auto')
    np.testing.assert_array_equal(traced.vertices, plain.vertices)
    np.testing.assert_array_equal(traced.faces, plain.faces)
    assert not [r for r in plain.trace.records if r.kind.endswith('search')]
    # a diagnostic search after the fit closes a search record of its own
    n = len(traced.trace.records)
    traced.distance_to_surface(pts[:50])
    rec = traced.trace.records[n:]
    assert [r.kind for r in rec] == ['search']
    assert rec[0].extra['method'] == 'brute'
    assert rec[0].extra['n_points'] == 50
    assert rec[0].extra['route'] == 'plain'
