"""The ERSim sweep cell (``ersim20k.sweep_entry``) driven end to end on
the CPU through the port's plain versions, at a size a test holds; and
its frozen acquisition (``benchmark/smlm.py``) against the port's
simulation at the published settings.

The small size: density 0.05 and detection 0.003 (about 960
localizations), the density seed at 1e-5 points/nm^3 (the entry's 2e-4
finds no surface in so thin a cloud) on a 24^3 grid, a 20 nm minimum
edge, 6 iterations with a remesh every 3.  Its limits, from runs of
three seeds and of the control and each fault on one:

* ``block_gap`` 1e-3: float32 against the float64 reference reads
  2.4e-6 to 3.6e-5; one vertex moved 2 nm reads 0.011, the bfloat16
  control 0.25, half the cloud 0.32, a block that does nothing 1.0;
* ``surgery_gap`` 5 nm: the sound runs read 2.4 to 3.0 nm, the remesh
  at 20 to 44 nm edges moving vertices off the surface it got;
* ``edge_gap`` 0.3: 0.019 to 0.020 sound, 1.08 with the remesh left out;
* ``shape_gap`` 25 nm: not held here, since six iterations do not bring
  the seed onto the shape (sound 12.1 to 13.6 nm, a fit that does
  nothing 14.8 nm); the cell's own limit holds it at the cell's size.
"""

import ast
import functools
import json
import os

import numpy as np
import pytest

from benchmark import faults, harness, smlm

CONFIG = {'cloud': {'shape': 'ersim', 'psf_width': 280,
                    'mean_photon_count': 300, 'bg_photon_count': 20,
                    'density': 0.05, 'p': 0.003, 'noise_fraction': 0.05},
          'seed': {'threshold_density': 1e-5, 'n_points_min': 20,
                   'grid_n': 24},
          'minimum_edge_length': 20.0}
WORKLOAD = {'iterations': 6, 'remesh_frequency': 3, 'warm_iterations': 3}
LIMITS = {'block_gap': 1e-3, 'surgery_gap': 5.0, 'edge_gap': 0.3,
          'neck_miss': 0.25, 'shape_gap': 25.0, 'defects': 0}
SEED = 5_000_000_011
CELL = 'ersim20k.sweep_entry'
with open(os.path.join(harness.HERE, 'configs', 'ersim20k.json')) as _fh:
    CLOUD = json.load(_fh)['cloud']
# the sweep's settings (configs/test_ersim.yaml), which the cell's are
PUBLISHED = dict(psf_width=280, mean_photon_count=300, bg_photon_count=20,
                 density=1.0, p=0.02, noise_fraction=0.05)
# the largest fitted surface of the port's entry on seeds 0-2 held
# 25,480 vertices (PERF.md section 2); 40,000 leaves 1.57 times that
V_MAX = 40_000


def run(trace=0, seed=SEED):
    return harness.run_cell(CELL, seed, 0.01, trace, device='cpu',
                            overrides=dict(config=CONFIG, workload=WORKLOAD,
                                           limits=LIMITS),
                            log=lambda *a: None)


@pytest.mark.parametrize('trace', [0, 1])
def test_sweep_cell_on_the_cpu(trace):
    r = run(trace)
    assert r['correct'] and r['failed'] == 0, r['compared']
    assert r['device']['platform'] == 'cpu'
    if trace:
        # search_s reads the port's search spans; k2s_roofline reads a
        # device trace, which a CPU run has not
        assert set(r['metrics']) == {'search_s'}
        assert r['metrics']['search_s']['value'] > 0
    else:
        assert set(r['metrics']) == {'fit_s', 'setup_s'}
    assert r['compared']['defects']['value'] == 0


def test_block_returning_its_state_is_not_correct():
    undo = faults.plant('unchanged')
    try:
        r = run()
    finally:
        undo()
    assert not r['correct']
    assert r['compared']['block_gap']['value'] == 1.0


@functools.lru_cache(maxsize=None)
def port_cloud(seed):
    from ch_shrinkwrap_torch.sim.pointcloud import \
        generate_smlm_pointcloud_from_shape
    p = PUBLISHED
    pts, _, sigma = generate_smlm_pointcloud_from_shape(
        'ERSim', {}, density=p['density'], p=p['p'],
        psf_width=(p['psf_width'],) * 3,
        mean_photon_count=p['mean_photon_count'],
        bg_photon_count=p['bg_photon_count'],
        noise_fraction=p['noise_fraction'], rng=seed)
    return pts, sigma


@functools.lru_cache(maxsize=None)
def frozen_cloud(seed):
    return smlm.acquisition64(seed, **PUBLISHED)


def test_cell_cloud_is_the_published_entry():
    assert {k: v for k, v in CLOUD.items() if k != 'shape'} == PUBLISHED
    assert CLOUD['shape'] == 'ersim'


def test_bounds_are_the_port_shapes():
    from ch_shrinkwrap_torch.sim.shape import ERSim
    shape = ERSim()
    r_max, centre = smlm.bounds()
    assert r_max == shape._radius
    np.testing.assert_array_equal(centre, shape.centroid)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_acquisition_is_the_port_simulation(seed):
    """Every draw as the port makes it: the same count, the same sigmas
    and the same float32 rows the fit takes.  The float64 rows part in
    the last bits at some surface sites (about 15%, by at most a few
    1e-13 nm): ``reference/shapes/ersim.py`` turns the sheets with plain
    products and sums where the port calls a BLAS matrix product, and
    the Newton steps carry that difference."""
    pts, sigma = frozen_cloud(seed)
    want_pts, want_sigma = port_cloud(seed)
    assert pts.shape == want_pts.shape
    np.testing.assert_array_equal(sigma, want_sigma)
    np.testing.assert_array_equal(pts.astype(np.float32),
                                  want_pts.astype(np.float32))
    differ = (pts != want_pts).any(1)
    assert differ.sum() <= 0.2 * len(pts)
    assert np.abs(pts - want_pts).max() <= 1e-12
    f32, s32 = smlm.ersim_cloud(CLOUD, seed)
    assert f32.dtype == s32.dtype == np.float32
    np.testing.assert_array_equal(f32, pts.astype(np.float32))


def test_published_size_takes_the_brute_search():
    """The model's 'auto' takes the brute-force search while N 2V stays
    within 2e9: at the published settings it does for any surface up to
    V_MAX vertices."""
    n = len(frozen_cloud(0)[0])
    assert 19_000 <= n <= 20_500
    assert n * 2 * V_MAX <= 2e9


def _top_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            out += [a.name.split('.')[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module.split('.')[0])
    return out


def test_acquisition_and_fit_kind_import_the_port_only_in_the_call():
    """``smlm.py`` imports nothing of the program at all; the fit kind
    imports the port inside its call, as its siblings do."""
    smlm_tree = ast.parse(open(smlm.__file__).read())
    for node in ast.walk(smlm_tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] + [
                getattr(node, 'module', None) or '']
            assert not any(n.startswith('ch_shrinkwrap') for n in names)
    sweep = os.path.join(harness.HERE, 'fits', 'sweep.py')
    assert 'ch_shrinkwrap_torch' not in _top_imports(sweep)
    assert set(_top_imports(smlm.__file__)) <= {'math', 'numpy', 'torch'}
