"""PyTorch port, the recipe layer held to the JAX package: the module
registry and every trait default (the port adds one trait, ``device``,
to the modules that build a MembraneMesh), the image recipe with and
without the shrink prior, and the YAML runner on a
PointcloudFromShape -> InitialSurface -> ShrinkwrapMembrane ->
MeshProperties document.
"""

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu import recipes as jrec
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh

import chip_smoke
from ch_shrinkwrap_torch import recipes as trec
from ch_shrinkwrap_torch.models.membrane_mesh import MembraneMesh as TMesh

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

DEVICE_MODULES = {'ShrinkwrapMembrane', 'ImageShrinkwrapMembrane',
                  'ScreenedPoissonMesh', 'AlphaWrap'}


def test_registry_names_equal():
    assert sorted(trec.MODULE_REGISTRY) == sorted(jrec.MODULE_REGISTRY)


@pytest.mark.parametrize('name', sorted(jrec.MODULE_REGISTRY))
def test_trait_defaults_equal(name):
    jt = jrec.MODULE_REGISTRY[name]._traits()
    tt = trec.MODULE_REGISTRY[name]._traits()
    extra = set(tt) - set(jt)
    assert extra == ({'device'} if name in DEVICE_MODULES else set())
    assert set(jt) <= set(tt)
    for k, trait in jt.items():
        assert type(tt[k]).__name__ == type(trait).__name__, k
        assert tt[k].default == trait.default, k
    if extra:
        assert tt['device'].default == 'cuda'


class Image:
    pass


def shell_image():
    """tests/test_harness.py:157's fixture: a 30-38 nm shell of weight
    in a 24^3 grid of 4 nm voxels."""
    n = 24
    x, y, z = np.mgrid[0:n, 0:n, 0:n]
    c = (n - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) * 4.0
    im = Image()
    im.data = ((r > 30) & (r < 38)).astype(np.float32)
    im.voxelsize_nm = (4.0, 4.0, 4.0)
    im.origin = (0.0, 0.0, 0.0)
    return im, c * 4


@pytest.mark.parametrize('shrink_weight', [0.0, 1.0])
def test_image_recipe_matches_jax(shrink_weight):
    im, c = shell_image()
    v, f = icosphere(2, radius=55.0, centre=(c, c, c))
    kw = dict(input='surf', input_image='im', output='out', max_iters=6,
              curvature_weight=4.0, shrink_weight=shrink_weight,
              remesh_frequency=3, neck_first_iter=-1,
              minimum_edge_length=8.0)
    nj = {'surf': JMesh(v, f), 'im': im}
    jrec.MODULE_REGISTRY['ImageShrinkwrapMembrane'](**kw).execute(nj)
    nt = {'surf': TMesh(v, f, device='cpu'), 'im': im}
    mod = trec.MODULE_REGISTRY['ImageShrinkwrapMembrane'](device='cpu',
                                                          **kw)
    mod.execute(nt)
    jm, tm = nj['out'], nt['out']
    assert tm.device.type == 'cpu'
    assert tm._last_diag.S.shape[-1] == (4 if shrink_weight else 3)
    rj = np.linalg.norm(jm.vertices - c, axis=1)
    rt = np.linalg.norm(tm.vertices - c, axis=1)
    assert rt.mean() < 48.0         # pulled from 55 toward the shell
    assert abs(rt.mean() - rj.mean()) < 0.1
    assert abs(rt.std() - rj.std()) < 0.1
    assert tm.euler_characteristic == jm.euler_characteristic
    assert tm.mdh['Processing.ImageShrinkwrapMembrane.shrink_weight'] \
        == shrink_weight


RECIPE_YAML = """
- simulation.PointcloudFromShape:
    shape_name: Sphere
    shape_params: "{'radius': 50.0}"
    density: 0.05
    p: 1.0
    psf_width_x: 100.0
    psf_width_y: 100.0
    psf_width_z: 200.0
    noise_fraction: 0.05
    random_seed: 4
    output: pts
- surface_fitting.InitialSurface:
    input: pts
    output: surf
    grid_n: 32
- surface_fitting.ShrinkwrapMembrane:
    input: surf
    points: pts
    output: membrane
    max_iters: 6
    curvature_weight: 4.0
    remesh_frequency: 3
    minimum_edge_length: 6.0
    neck_first_iter: -1
- surface_feature_extraction.MeshProperties:
    inputMesh: membrane
    output: props
"""


def test_yaml_recipe_runner_matches_jax():
    """The YAML document runs in both packages (the port's fit on the
    CPU through the ``device`` trait) to the same cloud, topology and
    radius."""
    nj = jrec.Recipe.from_yaml(RECIPE_YAML).execute()
    doc = RECIPE_YAML.replace('    neck_first_iter: -1\n',
                              '    neck_first_iter: -1\n'
                              '    device: cpu\n')
    r = trec.Recipe.from_yaml(doc)
    assert r.modules[2].device == 'cpu'
    nt = r.execute()
    for k in ('x', 'y', 'z', 'error_x'):
        np.testing.assert_array_equal(nt['pts'][k], nj['pts'][k])
    np.testing.assert_array_equal(nt['surf'].faces, nj['surf'].faces)
    tm, jm = nt['membrane'], nj['membrane']
    for k in ('euler', 'genus', 'manifold', 'components'):
        np.testing.assert_array_equal(nt['props'][k], nj['props'][k])
    assert int(nt['props']['euler'][0]) == 2
    assert int(nt['props']['components'][0]) == 1
    rt = np.linalg.norm(tm.vertices, axis=1)
    rj = np.linalg.norm(jm.vertices, axis=1)
    assert abs(rt.mean() - 50.0) < 3.0
    assert abs(rt.mean() - rj.mean()) < 0.1
    assert 'Processing.ShrinkwrapMembrane.Runtime' in tm.mdh


# ---------------------------------------------------------------------
# chip_smoke.py's image and sweep phases, at a tiny size on the CPU


def test_chip_smoke_cloud_image():
    pts, _ = chip_smoke.sphere_cloud(4000, radius=60.0)
    im = chip_smoke.cloud_image(pts, voxel=4.0)
    assert im.data.sum() == len(pts)
    lo = pts.min(0).astype(np.float64)
    np.testing.assert_allclose(im.origin, lo + 2.0)
    assert im.data.shape == tuple(
        np.ceil((pts.max(0) - lo) / 4.0).astype(int))


def test_chip_smoke_image_phase_on_cpu():
    """The image recipe with the shrink prior, the neck pass after
    iteration 9 and the trace's wall by phase."""
    fit = chip_smoke.phase_image('cpu', n_points=3000, radius=60.0,
                                 grid_n=12, iters=12, min_edge=8.0,
                                 voxel=4.0)
    assert fit['directions'] == 4
    assert fit['euler'] == 2 and fit['manifold'] and fit['components'] == 1
    kinds = [(rec[0], rec[1]) for rec in fit['trace']]
    assert ('remove_necks', 10) in kinds and ('remove_necks', 5) not in kinds
    assert 0.0 < fit['host_share'] < 1.0
    assert fit['n_pseudo'] == int(fit['n_pseudo']) > 1000


def test_chip_smoke_sweep_phase_on_cpu():
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
    sw = chip_smoke.phase_sweep(cfg, device='cpu', seed=3)
    chip_smoke.check_sweep(sw, euler=2)
    assert sw['rows'][0]['topology_correct']


def test_image_repeat_script_on_cpu():
    """scripts/torch_image_repeat.py at a tiny size: one run, its JSON
    result line and the summary line."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, 'scripts',
                                      'torch_image_repeat.py'),
         '--device', 'cpu', '--runs', '1', '--n-points', '3000',
         '--radius', '60', '--grid-n', '12', '--iters', '12',
         '--min-edge', '8', '--voxel', '4'],
        capture_output=True, text=True, timeout=300, cwd=repo)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith('{')]
    assert lines[-1] == {'runs': 1, 'intact': 1, 'breaks': 0}
    assert lines[0]['intact'] and lines[0]['euler'] == 2
