"""A new cell and a new metric are files and manifest entries: the
harness finds them in a copy of the benchmark without an edit."""

import json
import os
import shutil

from benchmark import harness


def test_new_cell_and_metric_are_found(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, 'benchmark'),
                    tmp_path / 'benchmark')
    with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as fh:
        m = json.load(fh)
    b = tmp_path / 'benchmark'
    (b / 'workloads' / 'short9.json').write_text(json.dumps(
        {'iterations': 9, 'remesh_frequency': 5, 'punch_frequency': 0,
         'min_hole_radius': 100.0, 'neck_first_iter': -1,
         'warm_iterations': 5}))
    (b / 'limits' / 'points1m.short9.json').write_text(json.dumps(
        {'block_gap': 0.1, 'surgery_gap': 0.1, 'edge_gap': 0.1,
         'neck_miss': 0.1, 'shape_gap': 1.0, 'defects': 0}))
    (b / 'metrics' / 'fits_in_window.py').write_text(
        "SOURCE = 'program_counter'\nLAYER = 'fit loop'\n\n\n"
        "def read(run):\n    return float(len(run.fits))\n")
    m['workloads'].append({'name': 'points1m.short9', 'config': 'points1m',
                           'traffic': 'short9', 'chips': 1,
                           'why': 'a test cell'})
    m['per_layer'].append({'name': 'fits_in_window', 'unit': 'fits',
                           'better': 'higher', 'source': 'program_counter',
                           'layer': 'fit loop', 'moves': 'fit_s',
                           'workloads': ['points1m.short9']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    cell = harness.Cell('points1m.short9', root=str(tmp_path))
    assert cell.workload['iterations'] == 9
    assert cell.limits['block_gap'] == 0.1
    assert [x['name'] for x in cell.per_layer] == ['fits_in_window']
    assert [x['name'] for x in cell.e2e] == ['fit_s', 'setup_s']

    class Run:
        fits = [{}, {}]
    mod = harness.metric_module('fits_in_window', cell.dir)
    assert mod.read(Run) == 2.0
    # the files of the accepted benchmark are left as they were
    for d in ('workloads', 'limits', 'metrics', 'configs'):
        old = set(os.listdir(os.path.join(harness.ROOT, 'benchmark', d)))
        assert old <= set(os.listdir(b / d))
