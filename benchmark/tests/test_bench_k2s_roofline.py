"""K2s's roofline reader on recorded calls: the benchmark's wrapper of
``cuda_scatter.segment_sum_ordered`` records each call's bound by
``counts.bounds.k2s_bound``, and ``k2s_roofline`` divides their sum by
the device seconds of the K2s family.  No cell lists it yet (a fit on
the windowed search launches no K2s), so it is held here."""

import pytest
import torch

from benchmark import harness
from benchmark.counts import bounds
from benchmark.instrument import Spans


def _calls():
    from ch_shrinkwrap_torch.ops import cuda_scatter
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((1000, 12), generator=g)
    tgt = torch.randint(0, 300, (1000,), generator=g, dtype=torch.int32)
    init = torch.randn((300, 3), generator=g)
    spans = Spans()
    spans.install()
    try:
        spans.calls = []
        out = cuda_scatter.segment_sum_ordered(rows, tgt, 300)
        cuda_scatter.segment_sum_ordered(rows[:, :3], tgt, 300, init=init)
    finally:
        spans.uninstall()
    want = cuda_scatter.segment_sum_ordered_plain(rows, tgt, 300)
    assert torch.equal(out, want)
    return spans.calls


def test_wrapper_records_the_bound_of_each_call():
    calls = _calls()
    assert calls == [
        ('k2s', (1000 * 12 * 4 + 1000 * 4 + 300 * 12 * 4) / 3.35e12),
        ('k2s', (1000 * 3 * 4 + 1000 * 4 + 300 * 3 * 4 + 300 * 3 * 4)
         / 3.35e12)]
    assert bounds.k2s_bound(1000, 10, 3)[1] == 'bytes'


def _run(calls, family_s):
    run = harness.Run(None, 0.0)
    run.calls = calls
    run.profile = None if family_s is None else dict(family_s=family_s)
    return run


def test_reader_on_recorded_calls():
    calls = _calls() + [('k2', 5e-6)]
    bound = sum(b for f, b in calls if f == 'k2s')
    read = harness.metric_module('k2s_roofline').read
    assert read(_run(calls, {'k2s': 4 * bound, 'k2': 1e-3})) == \
        pytest.approx(25.0)
    # no trace, no K2s launch, or no device time: nothing to read
    assert read(_run(calls, None)) is None
    assert read(_run([c for c in calls if c[0] != 'k2s'],
                     {'k2s': 1e-3})) is None
    assert read(_run(calls, {'k2': 1e-3})) is None
