"""PyTorch port, the fit's trace: the spans a whole fit records, from
``wrap_start`` to ``shrink_wrap``'s return, their nesting, their cover
of the fit's wall, their clock (that of ``torch.profiler``'s events),
and the records the JAX package's trace also keeps.

A fit on 1000 points with the windowed search (so the cloud is put in
order before the loop), a remesh every 5 iterations, a neck pass after
iteration 5 and a punch every 6, on the CPU under the CPU profiler.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ch_shrinkwrap_torch import native
from ch_shrinkwrap_torch.mesh.marching import wrap_start
from ch_shrinkwrap_torch.mesh.primitives import icosphere
from ch_shrinkwrap_torch.models import MembraneMesh
from ch_shrinkwrap_torch.models import membrane_mesh as mm
from ch_shrinkwrap_torch.utils.tracing import FitTrace

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = 'test.block'

FIT_KINDS = {
    'seed', 'seed/march', 'seed/march/field', 'seed/clean', 'seed/remesh',
    'seed/remesh/engine', 'seed/remesh/topology', 'seed/remesh/components',
    'construct', 'prep', 'prep/order', 'prep/upload',
    'cg_block', 'cg_block/sort', 'cg_block/pad', 'cg_block/tables',
    'cg_block/block', 'cg_block/update',
    'punch_holes', 'remove_necks', 'remove_necks/curvature',
    'remove_necks/repair', 'remove_necks/inner', 'short_edges',
    'remesh', 'remesh/engine', 'remesh/topology', 'remesh/components'}

# the extras of the record kinds the JAX package's trace keeps
JAX_EXTRAS = {
    'cg_block': ({'n_iters', 'v_cap', 'block_s'},
                 {'n_iters', 'v_cap', 'block_s', 'sort_s', 'pad_s',
                  'tables_s'}),
    'punch_holes': ({'n_punched'},),
    'remove_necks': ({'necks_flagged', 'necks_removed'},),
    'short_edges': (set(),),
    'remesh': ({'target_length'},)}


def _cloud(n=1000, R=50.0, sigma=5.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * R + rng.normal(scale=sigma, size=(n, 3))).astype(np.float32)
    return pts, np.full((n, 3), sigma, np.float32)


@pytest.fixture(scope='module')
def fit():
    """The profiled fit: its mesh, the wall from the ``wrap_start`` call
    to ``shrink_wrap``'s return (Unix ns), and the profiler's host
    events as (name, start_ns, end_ns, is_user_annotation).  Each CG
    block call runs inside the test's own ``record_function``."""
    pts, sig = _cloud()
    orig = mm.block_call

    def probed(*a, **k):
        with torch.profiler.record_function(PROBE):
            return orig(*a, **k)
    mm.block_call = probed
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            t0 = time.time_ns()
            surf = wrap_start(pts, offset=25.0, grid_n=12)
            mesh = MembraneMesh(
                mesh=surf, kc=1.0, step_size=20.0, max_iter=12,
                remesh_frequency=5, delaunay_remesh_frequency=6,
                delaunay_eps=100.0, neck_first_iter=5,
                neck_threshold_low=-1e-3, neck_threshold_high=1e-2,
                corr_method='windowed', device='cpu')
            mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                             minimum_edge_length=8.0)
            t1 = time.time_ns()
    finally:
        mm.block_call = orig
    events = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(),
               ev.is_user_annotation())
              for ev in prof.profiler.kineto_results.events()]
    return dict(mesh=mesh, t0=t0, t1=t1, events=events)


def test_every_span_kind_appears(fit):
    kinds = {r.kind for r in fit['mesh'].trace.records}
    assert FIT_KINDS <= kinds, FIT_KINDS - kinds


def test_children_lie_inside_their_parents(fit):
    recs = fit['mesh'].trace.records
    pos = {id(r): i for i, r in enumerate(recs)}
    for i, r in enumerate(recs):
        assert r.start_ns <= r.end_ns
        assert r.wall_time == (r.end_ns - r.start_ns) / 1e9
        p = r.parent
        if p is None:
            assert '/' not in r.kind
            continue
        assert r.kind.rsplit('/', 1)[0] == p.kind
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
        # a parent closes after its children
        assert pos[id(p)] > i


def test_top_level_spans_cover_the_fit(fit):
    recs = fit['mesh'].trace.records
    top = [r for r in recs if r.parent is None]
    assert [r.kind for r in top[:3]] == ['seed', 'construct', 'prep']
    for a, b in zip(top, top[1:]):
        assert a.end_ns <= b.start_ns
    assert fit['t0'] <= top[0].start_ns and top[-1].end_ns <= fit['t1']
    covered = sum(r.end_ns - r.start_ns for r in top)
    assert covered >= 0.9 * (fit['t1'] - fit['t0'])


def test_profiler_events_map_to_their_spans(fit):
    """The trace's clock is the profiler's: each probe opened inside a
    CG block's call maps to that ``cg_block/block`` span."""
    trace = fit['mesh'].trace
    probes = [e for e in fit['events'] if e[0] == PROBE]
    blocks = [r for r in trace.records if r.kind == 'cg_block/block']
    assert len(probes) == len(blocks) == 4
    for (_, s, e, _), blk in zip(sorted(probes), blocks):
        assert trace.span_at(s) is blk
        assert blk.start_ns <= s <= e <= blk.end_ns
    seed = [r for r in trace.records if r.kind == 'seed/march/field']
    assert trace.span_at(seed[0].start_ns + 1) is seed[0]
    assert trace.span_at(fit['t0'] - 10 ** 9) is None


def test_port_opens_no_profiler_annotation(fit):
    names = {e[0] for e in fit['events'] if e[3]}
    assert names == {PROBE}


def test_jax_kind_records_keep_their_extras(fit):
    recs = [r for r in fit['mesh'].trace.records if r.kind in JAX_EXTRAS]
    assert [(r.kind, r.iteration) for r in recs] == [
        ('cg_block', 5), ('short_edges', 5), ('remesh', 5),
        ('cg_block', 6), ('punch_holes', 6), ('cg_block', 10),
        ('remove_necks', 10), ('short_edges', 10), ('remesh', 10),
        ('cg_block', 12), ('punch_holes', 12)]
    for r in recs:
        assert set(r.extra) in JAX_EXTRAS[r.kind], (r.kind, r.extra)
        assert r.n_vertices > 0 and r.n_faces > 0
        if r.kind == 'cg_block':
            assert r.tests is not None and r.ress is not None
            block = [c for c in fit['mesh'].trace.records
                     if c.parent is r and c.kind == 'cg_block/block']
            # block_s runs from the call through the host update
            assert block[0].wall_time <= r.extra['block_s'] <= r.wall_time


def test_dump_jsonl_round_trips_times_and_parents(fit, tmp_path):
    trace = fit['mesh'].trace
    path = tmp_path / 'trace.jsonl'
    trace.dump_jsonl(str(path))
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == len(trace.records)
    for line, r in zip(lines, trace.records):
        assert (line['kind'], line['start_ns'], line['end_ns']) == \
            (r.kind, r.start_ns, r.end_ns)
        assert 'area' not in line
        if r.parent is None:
            assert line['parent'] is None
        else:
            assert trace.records[line['parent']] is r.parent


def test_engine_spans_carry_the_remesh_counts(monkeypatch):
    """A small closed sphere fit: each native remesh (the seed's and the
    scheduled ones) records the engine's counts on its ``engine`` span,
    and as the surface stays closed, the vertices out are the vertices
    in plus the splits less the collapses.  The ``remesh`` record keeps
    the JAX package's extras."""
    calls = []
    engine = native.remesh

    def counted(vertices, faces, *a, **k):
        out = engine(vertices, faces, *a, **k)
        calls.append((len(vertices), len(out[0]), out[2]))
        return out
    monkeypatch.setattr(native, 'remesh', counted)
    pts, sig = _cloud(seed=1)
    mesh = MembraneMesh(mesh=wrap_start(pts, offset=25.0, grid_n=12),
                        kc=1.0, step_size=20.0, max_iter=10,
                        remesh_frequency=5, device='cpu')
    mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                     minimum_edge_length=8.0)
    recs = mesh.trace.records
    spans = [r for r in recs if r.kind.endswith('remesh/engine')]
    assert [r.kind for r in spans] == ['seed/remesh/engine'] + \
        ['remesh/engine'] * (len(spans) - 1)
    assert len(spans) == len(calls) >= 3
    for rec, (n_in, n_out, counts) in zip(spans, calls):
        assert list(rec.extra) == list(native.REMESH_COUNTS)
        assert rec.extra == counts
        assert n_out == n_in + counts['splits'] - counts['collapses']
        assert counts['collapse_early_rejects'] <= \
            counts['collapse_attempts']
        assert counts['flip_early_rejects'] <= counts['flip_attempts']
    remeshes = [r for r in recs if r.kind == 'remesh']
    assert len(remeshes) == len(spans) - 1
    for r in remeshes:
        assert set(r.extra) in JAX_EXTRAS['remesh']


def test_short_edge_pass_spans():
    """A vertex moved onto its neighbour leaves an edge under 5% of the
    median: the pass removes it, in its ``repair`` and ``inner`` spans."""
    v, f = icosphere(2, radius=50.0)
    a, b = f[0, 0], f[0, 1]
    v = v.copy()
    v[a] = v[b] + 0.01 * (v[a] - v[b])
    mesh = MembraneMesh(v, f, device='cpu')
    with mesh.trace.span('short_edges'):
        mesh.remove_extra_short_edges(defer_remesh=True)
    kinds = [r.kind for r in mesh.trace.records]
    assert kinds == ['construct', 'short_edges/repair',
                     'short_edges/inner', 'short_edges']


def test_span_at_finds_the_innermost_span():
    trace = FitTrace()
    with trace.span('a'):
        with trace.span('b'):
            with trace.span('c'):
                time.sleep(0.001)
            time.sleep(0.001)
        time.sleep(0.001)
    a, b, c = (next(r for r in trace.records if r.kind == k)
               for k in ('a', 'a/b', 'a/b/c'))
    assert trace.span_at((c.start_ns + c.end_ns) // 2) is c
    assert trace.span_at(c.end_ns + 1) is b
    assert trace.span_at(b.end_ns + 1) is a
    assert trace.span_at(a.end_ns + 1) is None
    assert trace.span_at(a.start_ns - 1) is None
    # a continued trace keeps the records and the clock
    more = trace.continued()
    assert more.records == trace.records and more.records is not \
        trace.records
    assert more.offset_ns == trace.offset_ns


def test_e2e_script_idle_by_span_on_cpu():
    """``scripts/torch_e2e_fit.py --profile`` on the CPU, where the
    device runs nothing: the fit's whole wall is idle, and the idle
    seconds by span add up to it, the CG blocks' calls among them."""
    cmd = [sys.executable, os.path.join(REPO, 'scripts', 'torch_e2e_fit.py'),
           '--device', 'cpu', '--n-points', '1000', '--radius', '50',
           '--iters', '6', '--remesh-frequency', '3', '--punch-frequency',
           '0', '--neck-first-iter', '-1', '--minimum-edge-length', '8',
           '--grid-n', '12', '--profile']
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=240, env={**os.environ, 'OMP_NUM_THREADS':
                                         '1', 'PYTHONPATH': REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    idle = out['idle_by_span']
    assert out['device_busy_s'] == 0.0
    assert {'prep', 'cg_block/block', 'remesh/engine'} <= set(idle)
    assert abs(sum(idle.values()) - out['fit_s']) < 0.01 * out['fit_s']
