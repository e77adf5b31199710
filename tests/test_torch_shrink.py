"""PyTorch port, the rest of the solver and the model held to the JAX
package: the shrink prior, the in-block Gaussian curvature
(``want_curv_K``), the 'two' and 'bucketed' capacity modes, the device
K path of the neck diagnostic and the fit diagnostics
(``rms_point_sc``, ``distance_to_surface``, ``residual_histogram``).

Both packages start from the same numpy inputs.  Trajectory bounds are
the JAX suite's (tests/test_solver.py:403-404, 430-433); accumulations
are held to ``atol = 1e-4 * max|ref|`` (:338).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu.ops.curvature import curvature_grad as jcurv
from ch_shrinkwrap_tpu.solver import shrinkwrap as jsw

from ch_shrinkwrap_torch.convert import state_from_numpy
from ch_shrinkwrap_torch.models import MembraneMesh as TMesh
from ch_shrinkwrap_torch.ops.curvature import curvature_grad as tcurv
from ch_shrinkwrap_torch.solver import shrinkwrap as tsw

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


def sphere_cloud(R=50.0, n=3000, sigma=3.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1)[:, None]
    pts = v * R + rng.normal(scale=sigma, size=(n, 3))
    return pts.astype(np.float32), np.full((n, 3), sigma, np.float32)


def make_state(pts, sig, sub=3, radius=60.0):
    v, f = icosphere(sub, radius=radius)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    sigma_inv = (1.0 / sig).astype(np.float32)
    weights = (sigma_inv / np.sqrt((sigma_inv ** 2).sum())).astype(
        np.float32)
    a = dict(positions=np.asarray(ma.positions),
             v_mask=np.asarray(ma.v_mask), faces=np.asarray(ma.faces),
             f_mask=np.asarray(ma.f_mask), nbr_v=np.asarray(ma.nbr_v),
             nbr_f=np.asarray(ma.nbr_f),
             face_nbrs=np.asarray(ma.face_nbrs), points=pts,
             sigma_inv=sigma_inv, weights=weights,
             point_mask=np.ones(len(pts), bool))
    return a, state_from_numpy(device='cpu', **a)


def jax_args(a, lam0):
    return tuple(jnp.asarray(a[k]) for k in (
        'positions', 'faces', 'f_mask', 'v_mask', 'nbr_v', 'points',
        'sigma_inv', 'weights', 'point_mask')) + (lam0,)


def port_args(st, lam0):
    ma = st.ma
    return (ma.positions, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
            st.points, st.sigma_inv, st.weights, st.point_mask, lam0)


@pytest.fixture(scope='module')
def brute_case():
    return make_state(*sphere_cloud(n=3000))


@pytest.fixture(scope='module')
def windowed_case():
    pts, sig = sphere_cloud(n=4000, seed=3)
    pts = pts[jcorr.fit_point_order(pts)]
    # 320 faces: K1's plain version is float64 emulation
    return make_state(pts, sig, sub=2)


@pytest.mark.parametrize('method', ['brute', 'windowed'])
def test_cg_block_shrink_prior_matches_jax(request, method):
    """use_shrink adds the shrink prior as the third of four directions;
    the port's trajectory stays inside the JAX suite's bounds
    (tests/test_solver.py:403-404), and the prior moves the fit."""
    a, st = request.getfixturevalue(f'{method}_case')
    kw = dict(num_iters=6, corr_method=method, face_chunk=512)
    fj, dj = jsw.cg_block(*jax_args(a, 10.0), 10.0, use_shrink=True, **kw)
    ft, dt = tsw.cg_block(*port_args(st, 10.0), 10.0, use_shrink=True,
                          **kw)
    f0, _ = tsw.cg_block(*port_args(st, 10.0), 10.0, **kw)
    vm = a['v_mask']
    fj = np.asarray(fj)
    rj = np.linalg.norm(fj[vm], axis=1)
    rt = np.linalg.norm(ft.numpy()[vm], axis=1)
    assert abs(rj.mean() - rt.mean()) < 0.05
    assert np.abs(ft.numpy() - fj)[vm].max() < 0.5
    assert int(dt.n_done) == int(dj.n_done)
    assert dt.S.shape == np.asarray(dj.S).shape == (len(vm), 3, 4)
    np.testing.assert_allclose(dt.ress.numpy(), np.asarray(dj.ress),
                               rtol=1e-3)
    # the prior is live: without it the block ends elsewhere
    assert np.abs(ft.numpy() - f0.numpy())[vm].max() > 0.05
    np.testing.assert_array_equal(ft.numpy()[~vm], a['positions'][~vm])


def test_cg_block_shrink_prior_face_hcgc_matches_pointside(windowed_case):
    """The face-side normal equations at four directions reproduce the
    point-side solve (tests/test_solver.py:430-433)."""
    a, st = windowed_case
    kw = dict(num_iters=6, corr_method='windowed', use_shrink=True)
    fp, _ = tsw.cg_block(*port_args(st, 10.0), 3.0, **kw)
    ff, _ = tsw.cg_block(*port_args(st, 10.0), 3.0, face_hcgc=True, **kw)
    vm = a['v_mask']
    assert np.abs(fp.numpy() - ff.numpy())[vm].max() < 0.05
    rp = np.linalg.norm(fp.numpy()[vm], axis=1)
    rf = np.linalg.norm(ff.numpy()[vm], axis=1)
    assert abs(rp.mean() - rf.mean()) < 0.01


def test_cg_block_want_curv_K(brute_case):
    """diag.K is the port's curvature_grad K at the final positions
    (exact) and the JAX block's diag.K within the curvature tolerance
    of the suite (rtol 1e-3, tests/test_torch_membrane_mesh.py:123);
    it does not perturb the positions."""
    a, st = brute_case
    kw = dict(num_iters=3, corr_method='brute', face_chunk=512)
    f0, d0 = tsw.cg_block(*port_args(st, 10.0), **kw)
    assert d0.K is None
    fk, dk = tsw.cg_block(*port_args(st, 10.0), nbr_f=st.ma.nbr_f,
                          want_curv_K=True, **kw)
    np.testing.assert_array_equal(f0.numpy(), fk.numpy())
    ma = st.ma
    K_ref = tcurv(fk, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
                  ma.nbr_f).K
    np.testing.assert_array_equal(dk.K.numpy(), K_ref.numpy())
    fj, dj = jsw.cg_block(*jax_args(a, 10.0), nbr_f=jnp.asarray(a['nbr_f']),
                          want_curv_K=True, **kw)
    Kj = np.asarray(dj.K)
    vm = a['v_mask']
    np.testing.assert_allclose(dk.K.numpy()[vm], Kj[vm], rtol=1e-3,
                               atol=1e-3 * np.abs(Kj[vm]).max())
    # and the JAX curvature at the port's own positions agrees closer
    Kjt = np.asarray(jcurv(jnp.asarray(fk.numpy()), *(
        jnp.asarray(a[k]) for k in ('faces', 'f_mask', 'v_mask', 'nbr_v',
                                    'nbr_f'))).K)
    np.testing.assert_allclose(dk.K.numpy()[vm], Kjt[vm], rtol=1e-3,
                               atol=1e-4 * np.abs(Kjt[vm]).max())


def test_spmd_mesh_still_raises(brute_case):
    """spmd_mesh is ported: what is not a port DeviceMesh, or a mesh
    outside its process group, still raises."""
    from ch_shrinkwrap_torch.parallel.sharding import DeviceMesh
    _, st = brute_case
    with pytest.raises(TypeError):
        tsw.cg_block(*port_args(st, 2.0), num_iters=1, spmd_mesh=object())
    mesh = DeviceMesh(2, (torch.device('cpu'),) * 2, 'gloo')
    with pytest.raises(ValueError, match='process group'):
        tsw.cg_block(*port_args(st, 2.0), num_iters=1, spmd_mesh=mesh)


# ---------------------------------------------------------------------
# the model


def fit_pair(pts, sig, max_iter, sub=2, radius=60.0, **kw):
    v, f = icosphere(sub, radius=radius)
    jm = JMesh(v, f, **kw)
    jm.shrink_wrap(pts, sig, max_iter=max_iter, minimum_edge_length=6.0)
    tm = TMesh(v, f, device='cpu', **kw)
    tm.shrink_wrap(pts, sig, max_iter=max_iter, minimum_edge_length=6.0)
    return jm, tm


@pytest.mark.parametrize('mode', ['two', 'bucketed'])
def test_capacity_modes_match_jax(mode):
    """Each CG block's padded capacity equals the JAX package's on the
    CPU backend (exact), and both fits agree."""
    pts, sig = sphere_cloud(n=1500, sigma=4.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=3,
              delaunay_remesh_frequency=0, neck_first_iter=-1,
              capacity_mode=mode, pad_quantum=128)
    # a seed close to the cloud, so the mesh outgrows the 'two' mid rung
    # before the last block
    jm, tm = fit_pair(pts, sig, 15, radius=52.0, **kw)

    def caps(m):
        return [r.extra['v_cap'] for r in m.trace.records
                if r.kind == 'cg_block']
    cj, ct = caps(jm), caps(tm)
    assert ct == cj
    assert len(set(ct)) > 1          # the capacity moved during the fit
    assert tm._final_caps_pred == jm._final_caps_pred
    assert tm._cap_rungs == jm._cap_rungs
    rj = np.linalg.norm(jm.vertices, axis=1)
    rt = np.linalg.norm(tm.vertices, axis=1)
    assert abs(rj.mean() - rt.mean()) < 0.1
    assert tm.euler_characteristic == jm.euler_characteristic == 2


def test_shrink_weight_fit_matches_jax():
    """MembraneMesh(shrink_weight > 0) runs the shrink prior in every
    block, as the JAX package does."""
    pts, sig = sphere_cloud(n=1500, sigma=4.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=3,
              delaunay_remesh_frequency=0, neck_first_iter=-1,
              shrink_weight=1.0)
    jm, tm = fit_pair(pts, sig, 9, **kw)
    assert tm._last_diag.S.shape[-1] == 4
    rj = np.linalg.norm(jm.vertices, axis=1)
    rt = np.linalg.norm(tm.vertices, axis=1)
    assert abs(rj.mean() - rt.mean()) < 0.1
    assert abs(rj.std() - rt.std()) < 0.1
    assert abs(tm.vertices.shape[0] - jm.vertices.shape[0]) \
        <= 0.05 * jm.vertices.shape[0]
    assert tm.S3.shape == tm.vertices.shape


def test_device_neck_K_path_matches_native():
    """use_native_neck_k=False: the neck pass reads K from the CG
    block (want_curv_K) and flags what the native read flags."""
    pts, sig = sphere_cloud(n=1500, sigma=4.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=3,
              delaunay_remesh_frequency=0, neck_first_iter=2,
              neck_threshold_low=-2e-4, neck_threshold_high=1e-3)
    v, f = icosphere(2, radius=60.0)
    out = {}
    for native_k in (True, False):
        tm = TMesh(v, f, device='cpu', use_native_neck_k=native_k, **kw)
        tm.shrink_wrap(pts, sig, max_iter=6, minimum_edge_length=6.0)
        necks = [(r.iteration, r.extra['necks_flagged'])
                 for r in tm.trace.records if r.kind == 'remove_necks']
        out[native_k] = (necks, tm.vertices.shape[0])
    assert out[False][0] and out[False] == out[True]
    # the device path seeds the boundary K from the block
    tm = TMesh(v, f, device='cpu', use_native_neck_k=False, **kw)
    tm.shrink_wrap(pts, sig, max_iter=3, minimum_edge_length=6.0)
    assert tm._last_diag.K is not None


@pytest.fixture(scope='module')
def fitted_pair():
    """One fit in each package; the port's mesh then takes the JAX
    package's vertices, so the surface diagnostics read one surface."""
    pts, sig = sphere_cloud(n=1500, sigma=4.0, seed=5)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=0,
              delaunay_remesh_frequency=0, neck_first_iter=-1)
    jm, tm = fit_pair(pts, sig, 4, **kw)
    np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-3)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    return jm, tm, pts, sig


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_rms_point_sc_matches_jax(fitted_pair):
    """From each package's own last CG block."""
    jm, tm, _, _ = fitted_pair
    _close(tm.rms_point_sc, jm.rms_point_sc)
    assert 'rms_point_sc' in tm.vertex_properties


def test_distance_to_surface_and_histogram_match_jax(fitted_pair):
    jm, tm, pts, sig = fitted_pair
    tm.set_positions(np.array(jm.vertices, np.float32))
    _close(tm.distance_to_surface(pts), jm.distance_to_surface(pts))
    cj, ej, pj = jm.residual_histogram(bins=np.linspace(-20, 20, 41))
    ct, et, pt = tm.residual_histogram(bins=np.linspace(-20, 20, 41))
    np.testing.assert_array_equal(et, ej)
    _close(ct, cj)
    _close(pt, pj)
