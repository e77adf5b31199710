"""PyTorch port, the sweep harness held to the JAX package's contract
(tests/test_harness.py:44, :60, :75): sweep expansion, the skip on
restart, the device round robin (over CUDA cards, or threads sharing
the CPU) and the per-entry process isolation with its timeout.
"""

import copy
import glob
import json
import os
import queue

import pytest
import torch
import yaml

from ch_shrinkwrap_tpu.eval import harness as jh

from ch_shrinkwrap_torch.eval import harness as th

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MICRO_SWEEP = {
    'system': {'psf_width_x': [100.0], 'psf_width_y': [100.0],
               'psf_width_z': [200.0], 'mean_photon_count': [600],
               'bg_photon_count': [20]},
    'shape': {'type': ['Sphere'], 'parameters': [{'radius': 50.0}]},
    'point_cloud': {'density': [0.05], 'p': [1.0],
                    'noise_fraction': [0.02]},
    'dual_marching_cubes': {'threshold_density': [-1.0],
                            'n_points_min': [50]},
    'shrinkwrapping': {'max_iters': [6], 'curvature_weight': [4.0],
                       'remesh_frequency': [3], 'punch_frequency': [0],
                       'min_hole_radius': [100.0], 'neck_first_iter': [-1],
                       'neck_threshold_low': [-1e-3],
                       'neck_threshold_high': [1e-2]},
    'screened_poisson': {'samplespernode': [1.5], 'pointweight': [4.0],
                         'iters': [8], 'k': [10]},
}

CONFIGS = sorted(os.path.basename(p) for p in
                 glob.glob(os.path.join(REPO, 'configs', '*.yaml')))


@pytest.mark.parametrize('name', CONFIGS)
def test_testing_parameters_match_jax(name):
    """The repo's sweep configs expand to the same entries and the same
    entry hashes (the restart keys) in both packages."""
    with open(os.path.join(REPO, 'configs', name)) as fh:
        d = yaml.safe_load(fh)
    sw_t, spr_t = th.testing_parameters(copy.deepcopy(d))
    sw_j, spr_j = jh.testing_parameters(copy.deepcopy(d))
    assert sw_t == sw_j and spr_t == spr_j
    assert [th._param_hash({'kind': 'shrinkwrap', **p}) for p in sw_t] \
        == [jh._param_hash({'kind': 'shrinkwrap', **p}) for p in sw_j]


def test_evaluate_runs_and_restarts(tmp_path):
    """One entry on the CPU, its row as the JAX package writes it; a
    second evaluate in the same directory skips it."""
    out = str(tmp_path / 'sweep')
    results = th.evaluate(MICRO_SWEEP, out_dir=out, seed=3, device='cpu')
    assert len(results) == 1
    r = results[0]
    assert r['mse_rms'] < 20.0 and r['ntriangles'] > 100
    assert r['topology_correct'] and r['manifold']
    ref = jh.evaluate(MICRO_SWEEP, out_dir=str(tmp_path / 'jax'),
                      seed=3)[0]
    assert r['param_hash'] == ref['param_hash']
    for k in ('ntriangles', 'euler', 'manifold', 'components',
              'topology_correct'):
        assert r[k] == ref[k], k
    for k in ('mse_rms', 'sdf_rms', 'berger_mean_distance'):
        assert abs(r[k] - ref[k]) < 0.03 * abs(ref[k]), k

    assert th.evaluate(MICRO_SWEEP, out_dir=out, seed=3,
                       device='cpu') == []
    lines = open(os.path.join(out, 'metrics.jsonl')).read().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])['kind'] == 'shrinkwrap'


def test_evaluate_device_round_robin(tmp_path):
    """Two entries on two device threads give the serial sweep's rows
    (on the CPU both threads share it)."""
    d = copy.deepcopy(MICRO_SWEEP)
    d['shrinkwrapping'].update(curvature_weight=[4.0, 8.0], max_iters=[2])
    serial = th.evaluate(d, out_dir=str(tmp_path / 'serial'), seed=3,
                         device='cpu')
    par = th.evaluate(d, out_dir=str(tmp_path / 'par'), seed=3, devices=2,
                      device='cpu')
    assert len(par) == len(serial) == 2

    def key(r):
        return r['params']['curvature_weight']
    for a, b in zip(sorted(serial, key=key), sorted(par, key=key)):
        assert a['param_hash'] == b['param_hash']
        assert abs(a['mse_rms'] - b['mse_rms']) < 2.0


def test_sweep_devices_follow_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 3)
    assert th._sweep_devices('cuda') == ['cuda:0', 'cuda:1', 'cuda:2']
    assert th._sweep_devices('cuda', 2) == ['cuda:0', 'cuda:1']
    assert th._sweep_devices('cuda:2') == ['cuda:2']
    assert th._sweep_devices('cpu', 2) == ['cpu', 'cpu']
    with pytest.raises(ValueError):
        th._sweep_devices('cuda', 4)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(ValueError):        # no silent CPU fallback
        th._sweep_devices('cuda')


def test_isolated_workers_pin_one_card_each(monkeypatch, tmp_path):
    """Process isolation starts its workers with the 'spawn' method and
    hands each the next card in turn; the worker pins it before the
    entry runs.  (The processes are stood in for here; the entries
    record the device they were given.)"""
    import multiprocessing
    seen = {'methods': [], 'pinned': []}

    class Proc:
        def __init__(self, target, args):
            self.target, self.args, self.exitcode = target, args, 0

        def start(self):
            self.target(*self.args)

        def is_alive(self):
            return False

        def join(self):
            pass

        def terminate(self):
            pass

    class Ctx:
        Process = Proc

        @staticmethod
        def Queue(n):
            return queue.Queue(n)

    def get_context(method):
        seen['methods'].append(method)
        return Ctx

    monkeypatch.setattr(multiprocessing, 'get_context', get_context)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    monkeypatch.setattr(torch.cuda, 'set_device',
                        lambda d: seen['pinned'].append(d))
    monkeypatch.setattr(th, '_run_one_entry',
                        lambda kind, params, seed, out_dir, save_stl,
                        device: {'device': device})
    d = copy.deepcopy(MICRO_SWEEP)
    d['shrinkwrapping']['curvature_weight'] = [1.0, 2.0, 3.0]
    res = th.evaluate(d, out_dir=str(tmp_path), seed=0, n_workers=2)
    assert seen['methods'] == ['spawn']
    assert [r['device'] for r in res] == ['cuda:0', 'cuda:1', 'cuda:0']
    assert seen['pinned'] == ['cuda:0', 'cuda:1', 'cuda:0']


def test_evaluate_entry_timeout_kills_hung_entry(tmp_path):
    """A spawned worker past its timeout is terminated and counted as a
    failure instead of hanging the sweep."""
    out = str(tmp_path / 'sweep')
    results = th.evaluate(MICRO_SWEEP, out_dir=out, seed=3, n_workers=1,
                          entry_timeout=0.5, device='cpu')
    assert results == []
    path = os.path.join(out, 'metrics.jsonl')
    assert not os.path.exists(path) or open(path).read() == ''


def test_evaluate_rejects_two_kinds_of_parallelism(tmp_path):
    with pytest.raises(ValueError):
        th.evaluate(MICRO_SWEEP, out_dir=str(tmp_path), n_workers=2,
                    devices=2, device='cpu')
