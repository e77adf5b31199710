"""PyTorch port, the features of the sweep grids (``configs/*.yaml``)
that no other port test covers, held to the JAX package on the same
numpy inputs: the remesh collapse veto (``test_example_veto.yaml``), a
harness entry that punches a tunnel (``test_punch.yaml``), one whose
separator cuts a neck (``test_necks_separator.yaml``) and the same
entry through the recipe route (``test_necks_separator_recipe.yaml``),
and the record matching of ``scripts/torch_grids.py``.

The veto is host numpy plus the same native engine in both packages,
so the meshes are equal bit for bit.  The harness entries differ in
float rounding (the CG blocks), so, as in
``tests/test_torch_harness_entry.py``, the topology columns (with
``ntriangles``) are equal and the float columns are held to 3%; the
largest differences observed on these entries are 0.96% (the
separator entry, ``berger_smoothness_mean``) and under 0.01% (the
punch entry).  The fixtures are small: a coarse minimum edge keeps the
remesh away from the float-order ties that make longer fits diverge.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu.eval.harness import run_shrinkwrap_entry as jrun
from ch_shrinkwrap_tpu.mesh import remesh as j_remesh
from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JTri
from ch_shrinkwrap_tpu.mesh.marching import surface_from_function

from ch_shrinkwrap_torch.eval import harness as t_harness
from ch_shrinkwrap_torch.eval.harness import run_shrinkwrap_entry as trun
from ch_shrinkwrap_torch.mesh import remesh as t_remesh
from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TTri
from ch_shrinkwrap_torch.mesh.marching import initial_surface_from_density
from ch_shrinkwrap_torch.sim.pointcloud import \
    generate_smlm_pointcloud_from_shape

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'scripts'))

import torch_grids  # noqa: E402

TOPOLOGY = ('ntriangles', 'euler', 'manifold', 'components',
            'expected_euler', 'expected_components', 'topology_correct')
FLOATS = ('mse01', 'mse10', 'mse_rms', 'sdf_rms', 'sdf_mean_abs',
          'sdf_hausdorff', 'sdf_p99', 'berger_mean_distance',
          'berger_hausdorff', 'berger_smoothness_mean',
          'berger_smoothness_hausdorff')

COMMON = dict(density=1.0, p=0.05, psf_width=(100.0, 100.0, 100.0),
              mean_photon_count=600, bg_photon_count=20,
              noise_fraction=0.0, n_points_min=20, max_iter=6,
              curvature_weight=10.0, remesh_frequency=3,
              via_recipe=False, remesh_collapse_veto=False)

# a torus whose density seed closes the hole (Euler 2): the punch at
# iteration 3 must open it
PUNCH = dict(COMMON, shape_name='Torus', shape_params={'R': 40, 'r': 15},
             threshold_density=5e-4, grid_n=12, punch_frequency=3,
             min_hole_radius=15.0, neck_first_iter=-1,
             neck_threshold_low=-1e-4, neck_threshold_high=100.0,
             neck_detector='threshold', minimum_edge_length=10.0)

# two capsules whose density seed bridges the gap (one component): the
# separator must cut the neck into the two bodies
SEPARATOR = dict(COMMON, shape_name='CollinearCapsules',
                 shape_params={'length': 60, 'r': 15, 'gap': 8,
                               'expected_euler': 4,
                               'expected_components': 2},
                 threshold_density=1e-3, grid_n=24, punch_frequency=0,
                 min_hole_radius=50.0, neck_first_iter=2,
                 neck_threshold_low=-1e-3, neck_threshold_high=1e-2,
                 neck_detector='separator', minimum_edge_length=8.0)


def seed_topology(entry):
    """(Euler, components) of the entry's density seed."""
    sp = dict(entry['shape_params'])
    sp.pop('expected_euler', None)
    sp.pop('expected_components', None)
    pts, _, _ = generate_smlm_pointcloud_from_shape(
        entry['shape_name'], sp, density=entry['density'], p=entry['p'],
        psf_width=entry['psf_width'],
        mean_photon_count=entry['mean_photon_count'],
        bg_photon_count=entry['bg_photon_count'],
        noise_fraction=entry['noise_fraction'], rng=0)
    s = initial_surface_from_density(
        pts, threshold_density=entry['threshold_density'],
        n_points_min=entry['n_points_min'], grid_n=entry['grid_n'])
    return s.euler_characteristic, s.connected_components()[1]


def assert_entries_agree(entry):
    mt, mesh = trun(dict(entry), rng=0, device='cpu')
    mj, _ = jrun(dict(entry), rng=0)
    assert mesh.device.type == 'cpu'
    assert sorted(mt) == sorted(mj)
    for k in TOPOLOGY:
        assert mt[k] == mj[k], (k, mt[k], mj[k])
    for k in FLOATS:
        assert abs(mt[k] - mj[k]) <= 0.03 * abs(mj[k]), (k, mt[k], mj[k])
    return mt


# ---------------------------------------------------------------------
# the remesh collapse veto


@pytest.fixture(scope='module')
def thin_tube():
    """Two spheres joined by a tube of radius 2.5, marched at 2 nm: at
    a 4 nm target edge the tube's circumferential edges are what the
    veto protects."""
    def f(p):
        d1 = np.linalg.norm(p - np.array([-22.0, 0, 0]), axis=1) - 16.0
        d2 = np.linalg.norm(p - np.array([22.0, 0, 0]), axis=1) - 16.0
        x = np.clip(p[:, 0], -22, 22)
        dc = np.sqrt((p[:, 0] - x) ** 2 + p[:, 1] ** 2
                     + p[:, 2] ** 2) - 2.5
        return np.minimum(np.minimum(d1, d2), dc)

    return surface_from_function(f, (-42, -20, -20, 42, 20, 20), 2.0)


@pytest.mark.parametrize('native', [True, False],
                         ids=['native', 'numpy'])
def test_collapse_veto_bit_identical(thin_tube, native):
    """``remesh(collapse_veto_cos=0.5)`` through the native engine
    (``topology.cpp``'s veto) and the numpy passes
    (``collapse_pass(veto_cos=...)``): the port's mesh equals the JAX
    package's, and the veto changes the result."""
    v, f = thin_tube
    out = {}
    for veto in (None, 0.5):
        jm = j_remesh.remesh(JTri(v.copy(), f.copy()), 5, 4.0, 0.5,
                             n_relax=0, use_native=native,
                             collapse_veto_cos=veto)
        tm = t_remesh.remesh(TTri(v.copy(), f.copy()), 5, 4.0, 0.5,
                             n_relax=0, use_native=native,
                             collapse_veto_cos=veto)
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        np.testing.assert_array_equal(tm.faces, jm.faces)
        out[veto] = tm
    assert out[0.5].vertices.shape != out[None].vertices.shape
    assert out[0.5].is_manifold and out[0.5].euler_characteristic == 2


# ---------------------------------------------------------------------
# harness entries


def test_punch_entry_matches_jax():
    """A torus entry with ``punch_frequency`` 3: the seed is closed and
    both packages punch the tunnel (Euler 0, topology correct)."""
    assert seed_topology(PUNCH) == (2, 1)
    mt = assert_entries_agree(PUNCH)
    assert mt['euler'] == 0 and mt['topology_correct']


@pytest.mark.parametrize('via_recipe', [False, True],
                         ids=['direct', 'recipe'])
def test_separator_entry_matches_jax(via_recipe):
    """A CollinearCapsules entry with ``neck_detector='separator'``,
    directly and through the ShrinkwrapMembrane recipe: the seed is one
    body and both packages cut the neck (Euler 4, two components)."""
    assert seed_topology(SEPARATOR) == (2, 1)
    mt = assert_entries_agree(dict(SEPARATOR, via_recipe=via_recipe))
    assert (mt['euler'], mt['components']) == (4, 2)
    assert mt['topology_correct']


def test_evaluate_runs_only_the_chosen_entry(tmp_path):
    """``evaluate(only=...)`` runs one entry of a two-entry sweep and a
    second call skips it."""
    cfg = {
        'system': {'psf_width_x': [100.0], 'psf_width_y': [100.0],
                   'psf_width_z': [200.0], 'mean_photon_count': [600],
                   'bg_photon_count': [20]},
        'shape': {'type': ['Sphere'], 'parameters': [{'radius': 50.0}]},
        'point_cloud': {'density': [0.05], 'p': [1.0],
                        'noise_fraction': [0.02]},
        'dual_marching_cubes': {'threshold_density': [-1.0],
                                'n_points_min': [50]},
        'shrinkwrapping': {'max_iters': [2], 'curvature_weight': [4.0, 8.0],
                           'remesh_frequency': [3], 'punch_frequency': [0],
                           'min_hole_radius': [100.0],
                           'neck_first_iter': [-1],
                           'neck_threshold_low': [-1e-3],
                           'neck_threshold_high': [1e-2]},
    }
    sw, _ = t_harness.testing_parameters(cfg)
    hashes = [t_harness._param_hash({'kind': 'shrinkwrap', **p})
              for p in sw]
    assert len(hashes) == 2
    rows = t_harness.evaluate(cfg, out_dir=str(tmp_path), device='cpu',
                              only={hashes[1]})
    assert [r['param_hash'] for r in rows] == [hashes[1]]
    assert t_harness.evaluate(cfg, out_dir=str(tmp_path), device='cpu',
                              only={hashes[1]}) == []
    lines = (tmp_path / 'metrics.jsonl').read_text().splitlines()
    assert [json.loads(x)['param_hash'] for x in lines] == [hashes[1]]


# ---------------------------------------------------------------------
# scripts/torch_grids.py's records


def test_every_grid_entry_has_a_jax_record():
    """Each of the 49 entries of the twelve configs matches a JAX
    record on the parameters they share, and the records' scores per
    grid are the ones the records hold."""
    records = torch_grids.load_records()
    configs = sorted(os.path.join(REPO, 'configs', c)
                     for c in os.listdir(os.path.join(REPO, 'configs'))
                     if c.endswith('.yaml'))
    assert len(configs) == 12
    scores, n = {}, 0
    for c in configs:
        save_fp, entries = torch_grids.grid_entries(c)
        recs = [torch_grids.record_for(p, records) for _, p in entries]
        assert all(r is not None for r in recs), c
        n += len(entries)
        scores[os.path.basename(c)] = (
            sum(bool(r['row']['topology_correct']) for r in recs),
            len(recs), sorted({r['dir'] for r in recs}))
    assert n == 49
    assert scores['test_example_veto.yaml'] == (7, 8, ['eval_out_r5_veto'])
    assert scores['test_necks_separator_recipe.yaml'] == (
        1, 1, ['eval_out_necks_r5_recipe'])
    assert scores['test_necks_separator_dual.yaml'] == (
        0, 8, ['eval_out_necks_r4_dual'])
    assert scores['test_example.yaml'] == (8, 8, ['eval_out_r5'])


def test_records_skip_the_ports_rows(tmp_path, monkeypatch):
    """The port's own rows (``eval_out_torch*``) are never taken as a
    JAX record."""
    d = tmp_path / 'eval_out_torch' / 'x'
    d.mkdir(parents=True)
    (tmp_path / 'eval_out_torch' / 'metrics.jsonl').write_text(
        json.dumps({'kind': 'shrinkwrap', 'param_hash': 'x',
                    'params': {'max_iter': '3'}}) + '\n')
    assert torch_grids.load_records(str(tmp_path)) == []


def test_chip_smoke_grid_entries_resolve():
    """Each entry of ``chip_smoke.GRID_ENTRIES`` is an entry of its
    config; the recipe item is the same entry with ``via_recipe`` set,
    and its bound is stated."""
    import chip_smoke
    seen = set()
    for spec in chip_smoke.GRID_ENTRIES:
        test_d, h = chip_smoke.grid_entry(spec)
        sw, _ = t_harness.testing_parameters(test_d)
        params = [p for p in sw if t_harness._param_hash(
            {'kind': 'shrinkwrap', **p}) == h]
        assert len(params) == 1, spec
        assert params[0]['via_recipe'] is bool(spec.get('via_recipe'))
        assert 0 < spec['sdf_tol'] < 1.0 < spec['sdf_ref']
        seen.add(h)
    assert len(seen) == len(chip_smoke.GRID_ENTRIES)
