"""One cell driven end to end on the CPU through the port's plain
versions, at a size a test holds (``bench_tiny``): the result line's
keys, no device metric from a CPU run, and ``correct`` false under the
bfloat16 control and under each fault of ``benchmark.faults`` planted
in the timed path."""

import json
import os

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests import bench_tiny

KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device'}


def device_metrics():
    with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as fh:
        m = json.load(fh)
    return {x['name'] for x in m['end_to_end'] + m['per_layer']
            if x['source'] == 'device_trace'}


def check_line(r):
    assert set(r) - {'breakdown', 'compared'} == KEYS
    assert list(r)[-1] == 'compared'
    json.loads(json.dumps(r))
    assert not set(r['metrics']) & device_metrics()
    assert r['device']['platform'] == 'cpu'


@pytest.mark.parametrize('trace', [0, 1])
def test_cpu_run_line(trace):
    r = bench_tiny.run(trace=trace)
    check_line(r)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] >= 1
    want = {'fit_s', 'setup_s'} if not trace else {
        'seed_s', 'remesh_s', 'surgery_s', 'rebuild_s', 'block_s',
        'prep_s', 'update_s', 'remesh_engine_s', 'seed_field_s'}
    assert set(r['metrics']) == want
    assert r['compared']['defects']['value'] == 0


def test_control_is_not_correct():
    r = bench_tiny.run(control=True)
    check_line(r)
    assert not r['correct']
    gap = r['compared']['block_gap']
    assert gap['value'] > 10 * gap['limit']


@pytest.mark.parametrize('fault', faults.NAMES)
def test_fault_in_the_timed_path_is_not_correct(fault):
    undo = faults.plant(fault)
    try:
        r = bench_tiny.run()
    finally:
        undo()
    check_line(r)
    assert not r['correct']


@pytest.mark.cuda
def test_control_on_the_card(card):
    """The control at the tiny size on the card, on three seeds."""
    for seed in (11, 5_000_000_029, 2 ** 31 + 3):
        r = bench_tiny.run(control=True, seed=seed, device='cuda')
        assert not r['correct']
        r = bench_tiny.run(seed=seed, device='cuda')
        assert r['correct'], r['compared']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
