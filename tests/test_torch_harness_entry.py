"""PyTorch port, one sweep entry against the JAX package's
(tests/test_harness.py:234's entry), and the harness CLI on the CPU
with jax and the JAX package unimportable.

Tolerance of the float columns: the same cloud and seed surface, then
six CG iterations and two remeshes in each package, whose float32
sums round differently; the largest difference observed on this entry
is 1.4% (``berger_hausdorff``), so the columns are held to 3%.  The
topology columns are equal.
"""

import json
import os
import subprocess
import sys

import torch
import yaml

from ch_shrinkwrap_tpu.eval.harness import run_shrinkwrap_entry as jrun

from ch_shrinkwrap_torch.eval.harness import run_shrinkwrap_entry as trun

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENTRY = dict(shape_name='Sphere', shape_params={'radius': 60.0},
             density=0.01, p=1.0, psf_width=10.0, mean_photon_count=5000,
             bg_photon_count=20.0, noise_fraction=0.0,
             threshold_density=None, n_points_min=50, max_iter=6,
             curvature_weight=10.0, remesh_frequency=3, punch_frequency=0,
             min_hole_radius=100.0, neck_first_iter=-1,
             neck_threshold_low=-1e-3, neck_threshold_high=1e-2, grid_n=24)

TOPOLOGY = ('ntriangles', 'euler', 'manifold', 'components',
            'expected_euler', 'expected_components', 'topology_correct')
FLOATS = ('mse01', 'mse10', 'mse_rms', 'sdf_rms', 'sdf_mean_abs',
          'sdf_hausdorff', 'sdf_p99', 'berger_mean_distance',
          'berger_hausdorff', 'berger_smoothness_mean',
          'berger_smoothness_hausdorff')


def test_run_shrinkwrap_entry_matches_jax():
    mt, mesh = trun(dict(ENTRY), rng=0, device='cpu')
    mj, _ = jrun(dict(ENTRY), rng=0)
    assert mesh.device.type == 'cpu'
    assert sorted(mt) == sorted(mj)
    for k in TOPOLOGY:
        assert mt[k] == mj[k], k
    for k in FLOATS:
        assert abs(mt[k] - mj[k]) <= 0.03 * abs(mj[k]), k


def test_harness_cli_on_cpu_without_jax(tmp_path):
    """``python -m ch_shrinkwrap_torch.eval.harness <yaml> --device cpu
    --out DIR`` writes the sweep's rows, with jax and the JAX package
    unimportable."""
    cfg = {
        'system': {'psf_width_x': [100.0], 'psf_width_y': [100.0],
                   'psf_width_z': [200.0], 'mean_photon_count': [600],
                   'bg_photon_count': [20]},
        'shape': {'type': ['Sphere'], 'parameters': [{'radius': 50.0}]},
        'point_cloud': {'density': [0.05], 'p': [1.0],
                        'noise_fraction': [0.02]},
        'dual_marching_cubes': {'threshold_density': [-1.0],
                                'n_points_min': [50]},
        'shrinkwrapping': {'max_iters': [2], 'curvature_weight': [4.0],
                           'remesh_frequency': [3], 'punch_frequency': [0],
                           'min_hole_radius': [100.0],
                           'neck_first_iter': [-1],
                           'neck_threshold_low': [-1e-3],
                           'neck_threshold_high': [1e-2]},
    }
    path = tmp_path / 'micro.yaml'
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / 'out'
    code = (
        "import sys, runpy, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ch_shrinkwrap_tpu'] = None\n"
        f"sys.argv = ['harness', {str(path)!r}, '--device', 'cpu',\n"
        f"            '--out', {str(out)!r}]\n"
        "runpy.run_module('ch_shrinkwrap_torch.eval.harness',\n"
        "                 run_name='__main__')\n"
        "assert not any(k == 'jax' or k.startswith('jax.')\n"
        "               or k.startswith('ch_shrinkwrap_tpu')\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, 'PYTHONPATH': REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    rows = [json.loads(x) for x in
            (out / 'metrics.jsonl').read_text().splitlines()]
    assert len(rows) == 1
    assert rows[0]['topology_correct'] and rows[0]['ntriangles'] > 100
