"""The readers of the port's own spans (``prep_s``, ``update_s``,
``remesh_engine_s``, ``seed_field_s``): each reads every fit of a traced
run of the tiny cell, within the fit's wall, and a fit whose trace lacks
their kinds reads none: held here on each fit the harness records, where
the traced line gives only their means."""

import pytest

from benchmark import harness
from benchmark.tests import bench_tiny

NAMES = ('prep_s', 'update_s', 'remesh_engine_s', 'seed_field_s')


def _run(fits):
    run = harness.Run(None, 0.0)
    run.fits = fits
    return run


def test_traced_run_reads_the_program_spans(monkeypatch):
    fits, orig = [], harness.fit_record

    def keep(*a, **k):
        fits.append(orig(*a, **k))
        return fits[-1]
    monkeypatch.setattr(harness, 'fit_record', keep)
    r = bench_tiny.run(trace=1)
    assert r['correct'] and fits
    for name in NAMES:
        mod = harness.metric_module(name)
        assert mod.SOURCE == 'program_span' and mod.LAYER, name
        assert mod.read(_run(fits)) > 0.0, name
        for f in fits:
            assert 0.0 < mod.read(_run([f])) <= f['wall'], name


@pytest.mark.parametrize('name', NAMES)
def test_no_reading_without_the_span(name):
    """A fit whose trace holds only the block-level kinds, as a port
    without these spans records them: the metric is left out, not
    zero."""
    old = dict(wall=1.0, spans={'seed': 0.1},
               kinds={'cg_block': 0.5, 'remesh': 0.2, 'short_edges': 0.01},
               sort_s=0.01, pad_s=0.01, tables_s=0.0, block_s=0.4)
    mod = harness.metric_module(name)
    assert mod.read(_run([old])) is None
    assert mod.read(_run([])) is None
