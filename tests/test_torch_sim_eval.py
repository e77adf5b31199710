"""PyTorch port, the host modules held to the JAX package on the same
numpy inputs: the skeleton model, the Tikhonov CG solver, the
simulated clouds (bit-identical for one seed), the metrics (1e-12
relative) and the fit checkpoint (either package reads the other's).
"""

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu.eval import metrics as jmet
from ch_shrinkwrap_tpu.eval.harness import EXPECTED_TOPOLOGY as J_TOPO
from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JTri
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.models.skeleton_mesh import SkeletonMesh as JSkel
from ch_shrinkwrap_tpu.sim import shape as jshape
from ch_shrinkwrap_tpu.sim.pointcloud import \
    generate_smlm_pointcloud_from_shape as jgen
from ch_shrinkwrap_tpu.solver.tikhonov import TikhonovConjugateGradient \
    as JTik
from ch_shrinkwrap_tpu.utils import checkpoint as jckpt

from ch_shrinkwrap_torch import convert
from ch_shrinkwrap_torch.eval import metrics as tmet
from ch_shrinkwrap_torch.eval.harness import EXPECTED_TOPOLOGY as T_TOPO
from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TTri
from ch_shrinkwrap_torch.models.membrane_mesh import MembraneMesh as TMesh
from ch_shrinkwrap_torch.models.skeleton_mesh import SkeletonMesh as TSkel
from ch_shrinkwrap_torch.sim import shape as tshape
from ch_shrinkwrap_torch.sim.pointcloud import \
    generate_smlm_pointcloud_from_shape as tgen
from ch_shrinkwrap_torch.solver.tikhonov import TikhonovConjugateGradient \
    as TTik
from ch_shrinkwrap_torch.utils import checkpoint as tckpt

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


# ---------------------------------------------------------------------
# skeleton (fixtures of tests/test_skeleton.py:19 and :46)


def capsule():
    v, f = icosphere(3, radius=1.0)
    return v * np.array([40.0, 10.0, 10.0], np.float32), f


def inward_torus():
    R, r = 40.0, 10.0
    nu, nv = 48, 24
    rng = np.random.default_rng(1)
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vg = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, vg, indexing='ij')
    uu = uu + rng.uniform(-0.02, 0.02, uu.shape)
    vv = vv + rng.uniform(-0.05, 0.05, vv.shape)
    X = (R + r * np.cos(vv)) * np.cos(uu)
    Y = r * np.sin(vv)
    Z = (R + r * np.cos(vv)) * np.sin(uu)
    faces = []
    for i in range(nu):
        for j in range(nv):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            c = ((i + 1) % nu) * nv + (j + 1) % nv
            d2 = i * nv + (j + 1) % nv
            faces += [[a, b, c], [a, c, d2]]
    return (np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1).astype(
        np.float32), np.array(faces, np.int32))


SKELETON_CASES = {
    'capsule': (capsule, dict(max_iter=12, lam=[40.0],
                              target_edge_length=4.0,
                              area_variation_factor=1e-5)),
    'torus': (inward_torus, dict(max_iter=20, lam=[40.0],
                                 target_edge_length=5.0,
                                 area_variation_factor=1e-6,
                                 remesh_method='skeleton')),
}


@pytest.mark.parametrize('case', sorted(SKELETON_CASES))
def test_opt_skeleton_bit_identical(case):
    make, kw = SKELETON_CASES[case]
    v, f = make()
    js = JSkel(v, f)
    js.opt_skeleton(**kw)
    ts = TSkel(v, f, device='cpu')
    ts.opt_skeleton(**kw)
    np.testing.assert_array_equal(ts.vertices, js.vertices)
    np.testing.assert_array_equal(ts.faces, js.faces)


def test_shrink_wrap_skeleton_method_bit_identical():
    """``shrink_wrap(method='skeleton')`` on a plain MembraneMesh writes
    the skeleton's topology back, as in the JAX package."""
    v, f = capsule()
    kw = dict(max_iter=6, lam=[40.0], target_edge_length=4.0)
    jm = JMesh(v, f)
    jm.shrink_wrap(None, None, method='skeleton', **kw)
    tm = TMesh(v, f, device='cpu')
    tm.shrink_wrap(None, None, method='skeleton', **kw)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)


# ---------------------------------------------------------------------
# Tikhonov CG (tests/test_tikhonov.py:8)


def ridge():
    rng = np.random.default_rng(0)
    n, m = 80, 40
    A = rng.normal(size=(n, m))
    x_true = rng.normal(size=m)
    d = A @ x_true + 0.01 * rng.normal(size=n)
    return A, d, m


@pytest.mark.parametrize('operators', ['numpy', 'torch'])
def test_tikhonov_ridge_matches_jax(operators):
    """rtol 1e-10 with numpy operators (the same arithmetic as the JAX
    package's solver).  Torch's float64 matmul sums in another order,
    which 60 CG iterations spread to 3.6e-10 relative on this problem;
    the torch operators are held to 1e-8."""
    A, d, m = ridge()
    js = JTik(Afunc=lambda f: A @ f, Ahfunc=lambda r: A.T @ r)
    js.start_guess = lambda data: np.zeros(m)
    xj = js.search(d, [0.5], num_iters=60)
    if operators == 'numpy':
        ts = TTik(Afunc=lambda f: A @ f, Ahfunc=lambda r: A.T @ r)
    else:
        At = torch.from_numpy(A)
        ts = TTik(Afunc=lambda f: At @ f, Ahfunc=lambda r: At.T @ r,
                  device='cpu')
    ts.start_guess = lambda data: np.zeros(m)
    xt = ts.search(d, [0.5], num_iters=60)
    rtol = 1e-10 if operators == 'numpy' else 1e-8
    np.testing.assert_allclose(xt, xj, rtol=rtol, atol=0)
    np.testing.assert_allclose(ts.ress, js.ress, rtol=rtol)
    x_exact = np.linalg.solve(A.T @ A + 0.25 * np.eye(m), A.T @ d)
    np.testing.assert_allclose(xt, x_exact, atol=1e-3)


# ---------------------------------------------------------------------
# simulation: one seed, one cloud


SHAPE_PARAMS = {
    'Sphere': {'radius': 60.0},
    'Torus': {'r': 30, 'R': 100},
    'TwoToruses': {'r': 30, 'R': 100},
    'Capsule': {'start': [0, 0, 0], 'end': [200, 0, 0], 'radius': 50},
    'TaperedCapsule': {'r1': 40.0, 'r2': 20.0, 'length': 150.0},
    'TaperedEllipsoid': {'r1': 40.0, 'r2': 20.0, 'length': 150.0},
    'RoundCone': {'r1': 40.0, 'r2': 20.0, 'length': 150.0},
    'Box': {'halfwidth': [80, 60, 40], 'r': 10},
    'Sheet': {'halfwidth': [200, 200, 25], 'r': 20},
    'Tetrahedron': {'v0': [0.0, 0.0, 212.0], 'v1': [200.0, 0.0, -71.0],
                    'v2': [-100.0, 173.0, -71.0],
                    'v3': [-100.0, -173.0, -71.0]},
    'ThreeWayJunction': {'h': 150.0, 'r': 40.0},
    'ERSim': {},
}


def test_expected_topology_table_equal():
    assert T_TOPO == J_TOPO
    assert sorted(SHAPE_PARAMS) == sorted(J_TOPO)


@pytest.mark.parametrize('name', sorted(J_TOPO))
def test_pointcloud_bit_identical(name):
    kw = dict(density=0.002 if name == 'ERSim' else 0.02, p=0.5,
              psf_width=(120.0, 120.0, 240.0), mean_photon_count=400,
              bg_photon_count=20, noise_fraction=0.05, rng=7)
    pj, nj, sj = jgen(name, dict(SHAPE_PARAMS[name]), **kw)
    pt, nt, st = tgen(name, dict(SHAPE_PARAMS[name]), **kw)
    assert len(pt) > 100
    for a, b in ((pt, pj), (nt, nj), (st, sj)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_clean_pointcloud_and_shape_oracle_bit_identical():
    """psf_width=None (the Berger oracle sample) and the SDF itself."""
    kw = dict(density=0.05, p=1.0, psf_width=None, noise_fraction=0.0,
              rng=3)
    pj, nj, _ = jgen('Torus', {'r': 30, 'R': 100}, **kw)
    pt, nt, _ = tgen('Torus', {'r': 30, 'R': 100}, **kw)
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(nt, nj)
    x = np.random.default_rng(0).uniform(-150, 150, size=(3, 500))
    np.testing.assert_array_equal(tshape.ERSim().sdf(x),
                                  jshape.ERSim().sdf(x))


# ---------------------------------------------------------------------
# metrics


@pytest.fixture(scope='module')
def metric_inputs():
    v, f = icosphere(3, radius=20.0)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(3000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    truth = d * 20.0 + rng.normal(scale=0.5, size=d.shape)
    return v, f, truth, d


def _rel(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize('sampler', ['mc', 'raster'])
def test_points_from_mesh_matches_jax(metric_inputs, sampler):
    v, f, _, _ = metric_inputs
    pj, nj = jmet.points_from_mesh(JTri(v, f), dx_min=2.0, p=0.8,
                                   return_normals=True, rng=1,
                                   sampler=sampler)
    pt, nt = tmet.points_from_mesh(TTri(v, f), dx_min=2.0, p=0.8,
                                   return_normals=True, rng=1,
                                   sampler=sampler)
    _rel(pt, pj)
    _rel(nt, nj)


def test_distance_metrics_match_jax(metric_inputs):
    v, f, truth, d = metric_inputs
    m = tmet.points_from_mesh(TTri(v, f), dx_min=2.0, rng=0)
    _rel(tmet.average_squared_distance(truth, m),
         jmet.average_squared_distance(truth, m))
    _rel(tmet.mean_and_hausdorff_distance(truth, m),
         jmet.mean_and_hausdorff_distance(truth, m))
    mn = m / np.linalg.norm(m, axis=1)[:, None]
    _rel(tmet.hausdorff_smoothness(truth, m, d, mn),
         jmet.hausdorff_smoothness(truth, m, d, mn))
    pj = jmet.construct_ordered_pairs_berger(truth, m, d, mn, dx_max=2.0)
    pt = tmet.construct_ordered_pairs_berger(truth, m, d, mn, dx_max=2.0)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a, b)
    _rel(tmet.berger_mean_and_hausdorff(truth, m, *pt),
         jmet.berger_mean_and_hausdorff(truth, m, *pj))
    _rel(tmet.berger_smoothness(d, mn, *pt),
         jmet.berger_smoothness(d, mn, *pj))


def test_mesh_metric_panels_match_jax(metric_inputs):
    v, f, truth, d = metric_inputs
    mj = jmet.compute_mesh_metrics(JTri(v, f), truth, truth_normals=d,
                                   dx_min=2.0, rng=0)
    mt = tmet.compute_mesh_metrics(TTri(v, f), truth, truth_normals=d,
                                   dx_min=2.0, rng=0)
    assert sorted(mt) == sorted(mj)
    for k in mj:
        _rel(mt[k], mj[k])
    sj = jmet.mesh_metrics_vs_shape(JTri(v, f), jshape.Sphere(radius=20.0),
                                    rng=2)
    st = tmet.mesh_metrics_vs_shape(TTri(v, f), tshape.Sphere(radius=20.0),
                                    rng=2)
    assert sorted(st) == sorted(sj)
    for k in sj:
        _rel(st[k], sj[k])


# ---------------------------------------------------------------------
# checkpoints across packages


def _fitted(cls, **kw):
    v, f = icosphere(2, radius=30.0)
    m = cls(v, f, shrink_weight=0.25, neck_detector='separator',
            neck_first_iter=7, step_size=3.0, **kw)
    m._points = np.random.default_rng(0).normal(size=(50, 3)).astype(
        np.float32)
    m._sigma = 4.0
    return m


@pytest.mark.parametrize('writer', ['jax', 'torch'])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / 'ckpt.npz')
    if writer == 'jax':
        src = _fitted(JMesh)
        jckpt.save_fit_state(src, path, iteration=12)
        out, it = tckpt.load_fit_state(path, device='cpu')
        assert isinstance(out, TMesh) and out.device.type == 'cpu'
    else:
        src = _fitted(TMesh, device='cpu')
        tckpt.save_fit_state(src, path, iteration=12)
        out, it = jckpt.load_fit_state(path)
        assert isinstance(out, JMesh)
    assert it == 12
    np.testing.assert_array_equal(out.vertices, src.vertices)
    np.testing.assert_array_equal(out.faces, src.faces)
    np.testing.assert_array_equal(out._points, src._points)
    for k in tckpt.FIT_PARAMETERS:
        assert getattr(out, k) == getattr(src, k), k
    assert float(out._sigma) == 4.0
    with np.load(path) as z:
        keys = sorted(z.files)
    other = str(tmp_path / 'other.npz')
    (tckpt if writer == 'jax' else jckpt).save_fit_state(out, other, 12)
    with np.load(other) as z:
        assert sorted(z.files) == keys


def test_membrane_mesh_from_jax_model():
    src = _fitted(JMesh)
    out = convert.membrane_mesh_from(src, device='cpu')
    np.testing.assert_array_equal(out.vertices, src.vertices)
    np.testing.assert_array_equal(out.faces, src.faces)
    for k in tckpt.FIT_PARAMETERS:
        assert getattr(out, k) == getattr(src, k), k
    assert out.shrink_weight == 0.25 and out.neck_detector == 'separator'
    np.testing.assert_array_equal(out._points, src._points)
