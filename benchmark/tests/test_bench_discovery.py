"""A new cell, a new metric and a new true shape are files and manifest
entries: the harness finds them in a copy of the benchmark without an
edit, and a configuration whose shape has no module fails the cell
before any set-up."""

import json
import os
import shutil

import pytest
import torch

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


def _copy_with_config(tmp_path, shape):
    """A copy of the benchmark with a configuration ``points1m_<shape>``
    whose cloud names ``shape``, and a cell ``<config>.plain39``."""
    shutil.copytree(os.path.join(harness.ROOT, 'benchmark'),
                    tmp_path / 'benchmark')
    with open(os.path.join(harness.ROOT, 'BENCHMARK.json')) as fh:
        m = json.load(fh)
    cfg = harness.load_json(os.path.join(harness.ROOT, 'benchmark',
                                         'configs', 'points1m.json'))
    cfg['cloud'] = dict(cfg['cloud'], shape=shape)
    name = 'points1m_' + shape
    b = tmp_path / 'benchmark'
    (b / 'configs' / (name + '.json')).write_text(json.dumps(cfg))
    (b / 'limits' / (name + '.plain39.json')).write_text(
        (b / 'limits' / 'points1m.plain39.json').read_text())
    m['configs'].append({'name': name, 'source': 'a test',
                         'file': f'benchmark/configs/{name}.json',
                         'reduced': [], 'why': 'a test configuration'})
    m['workloads'].append({'name': name + '.plain39', 'config': name,
                           'traffic': 'plain39', 'chips': 1,
                           'why': 'a test cell'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(m))
    return name + '.plain39', b


def test_new_shape_is_found(tmp_path):
    cell_name, b = _copy_with_config(tmp_path, 'cube')
    (b / 'reference' / 'shapes' / 'cube.py').write_text(
        "import torch\n\n\n"
        "def gap(vertices, cloud):\n"
        "    d = vertices.abs().max(1).values - cloud['radius']\n"
        "    return float(d.abs().mean())\n")
    cell = harness.Cell(cell_name, root=str(tmp_path))
    v = torch.tensor([[510.0, 0.0, 0.0], [0.0, -480.0, 3.0]],
                     dtype=torch.float64)
    assert cell.shape.gap(v, cell.config['cloud']) == 15.0
    old = set(os.listdir(os.path.join(harness.HERE, 'reference', 'shapes')))
    assert old <= set(os.listdir(b / 'reference' / 'shapes'))


def test_unknown_shape_fails_the_cell(tmp_path):
    cell_name, _ = _copy_with_config(tmp_path, 'dodecahedron')
    with pytest.raises(SystemExit, match=r"'dodecahedron'.*'ersim', "
                                         r"'sphere'"):
        harness.Cell(cell_name, root=str(tmp_path))
