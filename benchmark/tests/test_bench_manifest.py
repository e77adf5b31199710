"""The manifest and every file it names: keys, names, units, and that
each metric's reader states the manifest's source and layer."""

import json
import os
import re

import pytest

from benchmark import check, harness

ROOT = harness.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def manifest():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert m['paths'] == ['benchmark']
    assert 1 <= m['run_seconds'] <= 51
    names = [c['name'] for c in m['configs']] \
        + [w['name'] for w in m['workloads']] \
        + [x['name'] for x in m['end_to_end'] + m['per_layer']]
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in m['workloads']]:
        assert NAME.match(n), n
    for x in m['end_to_end'] + m['per_layer']:
        assert UNIT.match(x['unit']), x
        assert x['better'] in ('lower', 'higher')
    assert {x['name'] for x in m['end_to_end']} == {'fit_s', 'setup_s'}
    for x in m['end_to_end']:
        assert 'workloads' not in x      # every cell reports it
        assert 0.01 <= x['bound'] <= 0.25
        assert x['source'] in ('host_clock', 'device_trace')
    for w in m['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200


def test_every_file_the_manifest_names_parses():
    m = manifest()
    used = {w['config'] for w in m['workloads']}
    assert used == {c['name'] for c in m['configs']}
    for c in m['configs']:
        assert c['file'].startswith('benchmark/configs/')
        with open(os.path.join(ROOT, c['file'])) as fh:
            cfg = json.load(fh)
        assert os.path.exists(os.path.join(
            ROOT, 'benchmark', 'fits', cfg['fit'] + '.py'))
        assert set(c['reduced']) <= set(cfg)
    for w in m['workloads']:
        cell = harness.Cell(w['name'])
        assert cell.workload['warm_iterations'] <= cell.workload['iterations']
        assert set(cell.limits) == set(check.NUMBERS)
        assert cell.limits['defects'] == 0
        assert cell.per_layer, w['name']


@pytest.mark.parametrize('metric', [x['name'] for x in
                                    manifest()['end_to_end']
                                    + manifest()['per_layer']])
def test_metric_reader_states_its_source_and_layer(metric):
    entry = {x['name']: x for x in manifest()['end_to_end']
             + manifest()['per_layer']}[metric]
    mod = harness.metric_module(metric)
    assert mod.SOURCE == entry['source']
    if 'layer' in entry:
        assert mod.LAYER == entry['layer']
        assert entry['moves'] == 'fit_s'
        cells = {w['name'] for w in manifest()['workloads']}
        assert entry['workloads'] and set(entry['workloads']) <= cells
