"""PyTorch port, the CG block held to the JAX package's ``cg_block``.

Both packages start from the same state: the JAX package's padded
arrays and inputs, fetched to numpy and carried into tensors by
``convert.state_from_numpy``.  Bounds are the JAX suite's own
(tests/test_solver.py:126-185 and :384-478).  The windowed path is
compared with the JAX 'windowed' path, which the JAX suite holds to its
Pallas path; interpret mode would be too slow here.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu.ops import normals as jnrm
from ch_shrinkwrap_tpu.solver import shrinkwrap as jsw

from ch_shrinkwrap_torch.convert import state_from_numpy
from ch_shrinkwrap_torch.ops import meshdata as tmd
from ch_shrinkwrap_torch.solver import shrinkwrap as tsw

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


def sphere_cloud(R=50.0, n=3000, sigma=5.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1)[:, None]
    pts = v * R + rng.normal(scale=sigma, size=(n, 3))
    return pts.astype(np.float32), np.full((n, 3), sigma, np.float32)


def make_state(pts, sig, sub=3, radius=60.0, normalize='mean'):
    """The JAX package's padded arrays and inputs as numpy, and the
    port's FitState built from them."""
    v, f = icosphere(sub, radius=radius)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    sigma_inv = (1.0 / sig).astype(np.float32)
    if normalize == 'mean':
        weights = sigma_inv / sigma_inv.mean()
    else:
        weights = sigma_inv / np.sqrt((sigma_inv ** 2).sum())
    arrays = dict(positions=np.asarray(ma.positions),
                  v_mask=np.asarray(ma.v_mask), faces=np.asarray(ma.faces),
                  f_mask=np.asarray(ma.f_mask), nbr_v=np.asarray(ma.nbr_v),
                  nbr_f=np.asarray(ma.nbr_f),
                  face_nbrs=np.asarray(ma.face_nbrs), points=pts,
                  sigma_inv=sigma_inv, weights=weights.astype(np.float32),
                  point_mask=np.ones(len(pts), bool))
    st = state_from_numpy(device='cpu', **arrays)
    return arrays, st


def jax_args(a, lam0):
    return (jnp.asarray(a['positions']), jnp.asarray(a['faces']),
            jnp.asarray(a['f_mask']), jnp.asarray(a['v_mask']),
            jnp.asarray(a['nbr_v']), jnp.asarray(a['points']),
            jnp.asarray(a['sigma_inv']), jnp.asarray(a['weights']),
            jnp.asarray(a['point_mask']), lam0)


def port_args(st, lam0, positions=None):
    ma = st.ma
    return (ma.positions if positions is None else positions, ma.faces,
            ma.f_mask, ma.v_mask, ma.nbr_v, st.points, st.sigma_inv,
            st.weights, st.point_mask, lam0)


def test_state_from_numpy_is_bit_identical():
    pts, sig = sphere_cloud(n=500)
    a, st = make_state(pts, sig, sub=2)
    for name in ('positions', 'v_mask', 'faces', 'f_mask', 'nbr_v',
                 'nbr_f', 'face_nbrs'):
        x = getattr(st.ma, name)
        np.testing.assert_array_equal(x.numpy(), a[name])
    assert st.ma.faces.dtype == torch.int32
    assert st.ma.v_mask.dtype == torch.bool
    np.testing.assert_array_equal(st.points.numpy(), pts)
    np.testing.assert_array_equal(st.weights.numpy(), a['weights'])
    assert st.ma.host['V'] == int(a['v_mask'].sum())


@pytest.fixture(scope='module')
def ncc_inputs():
    rng = np.random.default_rng(11)
    Vp, K = 2048, 20
    f = rng.normal(size=(Vp, 3)).astype(np.float32)
    vn = rng.normal(size=(Vp, 3)).astype(np.float32)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    pi = rng.random(Vp).astype(np.float32)
    v_mask = np.ones(Vp, bool)
    v_mask[-10:] = False
    nbr = rng.integers(0, Vp, size=(Vp, K)).astype(np.int32)
    nbr[rng.random((Vp, K)) < 0.4] = -1       # many rows exceed NCC_K
    nbr[5] = -1                               # an isolated vertex
    return f, nbr, vn, pi, v_mask


def test_compute_ncc_plain_matches_jax(ncc_inputs):
    f, nbr, vn, pi, v_mask = ncc_inputs
    ref = np.asarray(jsw.compute_ncc(*map(jnp.asarray,
                                           (f, nbr, vn, pi, v_mask))))
    out = tsw.compute_ncc(*map(torch.from_numpy, (f, nbr, vn, pi, v_mask)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_compute_ncc_kmajor_matches_plain(ncc_inputs):
    """The k-major form (K3 gather over the NCC_K-slot stream plus exact
    overflow pairs) reproduces the plain K=20 form
    (tests/test_ring_gather.py:468)."""
    f, nbr, vn, pi, v_mask = ncc_inputs
    Vp = f.shape[0]
    st = state_from_numpy(
        positions=f, v_mask=v_mask, faces=np.zeros((8, 3), np.int32),
        f_mask=np.zeros(8, bool), nbr_v=nbr, device='cpu')
    g = tmd.gather_tables(st.ma)
    assert g.ncc_ov is not None and g.ncc_ov[0].numel() > 100
    args = [torch.from_numpy(x) for x in (f, nbr, vn, pi, v_mask)]
    plain = tsw.compute_ncc(*args)
    kmaj = tsw.compute_ncc(*args, kmajor=(g.ncc_idx, g.ncc_care, g.ncc_ov))
    np.testing.assert_allclose(kmaj.numpy(), plain.numpy(), rtol=3e-5,
                               atol=3e-5)
    assert np.array_equal(kmaj.numpy()[5], f[5])
    assert kmaj.shape == (Vp, 3)


def test_ncc_sphere_prior_points_inward():
    """Zero point influence: the prior is the plain neighbour centroid,
    inside the sphere (tests/test_solver.py:98-112)."""
    v, f = icosphere(3, radius=10.0)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    vn = jnrm.vertex_normals(ma.positions, ma.faces, ma.f_mask,
                             ma.positions.shape[0])
    ncc = tsw.compute_ncc(torch.from_numpy(np.array(ma.positions)),
                          torch.from_numpy(np.array(ma.nbr_v)),
                          torch.from_numpy(np.array(vn)),
                          torch.zeros(ma.positions.shape[0]),
                          torch.from_numpy(np.array(ma.v_mask)))
    r = np.linalg.norm(ncc.numpy()[np.asarray(ma.v_mask)], axis=1)
    assert (r < 10.0).all() and (r > 9.0).all()


def test_cg_block_brute_converges_like_jax():
    """8 blocks of 5 brute-force iterations from an offset sphere
    (tests/test_solver.py:115-145): both packages settle on the cloud,
    and their trajectories agree."""
    pts, sig = sphere_cloud(R=50.0, n=3000, sigma=3.0)
    a, st = make_state(pts, sig)
    fj = jnp.asarray(a['positions'])
    ft = st.ma.positions
    jargs = jax_args(a, 2.0)
    first_t = first_j = None
    for _ in range(8):
        fj, dj = jsw.cg_block(fj, *jargs[1:], num_iters=5, face_chunk=512)
        ft, dt = tsw.cg_block(*port_args(st, 2.0, ft), num_iters=5,
                              face_chunk=512)
        if first_t is None:
            first_t = float(dt.ress[0])
            first_j = float(np.asarray(dj.ress)[0])
            np.testing.assert_allclose(dt.ress.numpy(),
                                       np.asarray(dj.ress), rtol=1e-3)
    m = a['v_mask']
    r1 = np.linalg.norm(ft.numpy()[m], axis=1)
    assert abs(r1.mean() - 50.0) < 1.0
    assert r1.std() < 1.5
    assert float(dt.ress[-1]) < first_t
    assert dt.point_influence.numpy()[m].max() > 0
    assert int(dt.n_done) == 5
    rj = np.linalg.norm(np.asarray(fj)[m], axis=1)
    assert abs(r1.mean() - rj.mean()) < 0.05
    assert np.abs(ft.numpy() - np.asarray(fj))[m].max() < 0.5
    np.testing.assert_allclose(first_t, first_j, rtol=1e-4)


@pytest.fixture(scope='module')
def windowed_case():
    pts, sig = sphere_cloud(n=8000, seed=3)
    pts = pts[jcorr.fit_point_order(pts)]
    a, st = make_state(pts, sig, normalize='l2')
    return a, st


def test_cg_block_windowed_matches_jax_windowed(windowed_case):
    """Port 'windowed' (K1 + K2 plain versions on CPU) against the JAX
    'windowed' path at the bounds of tests/test_solver.py:403-404."""
    a, st = windowed_case
    fj, dj = jsw.cg_block(*jax_args(a, 10.0), num_iters=6,
                          corr_method='windowed')
    ft, dt = tsw.cg_block(*port_args(st, 10.0), num_iters=6,
                          corr_method='windowed')
    fb, _ = jsw.cg_block(*jax_args(a, 10.0), num_iters=6,
                         corr_method='brute')
    vm = a['v_mask']
    for ref in (np.asarray(fj), np.asarray(fb)):
        rr = np.linalg.norm(ref[vm], axis=1)
        rt = np.linalg.norm(ft.numpy()[vm], axis=1)
        assert abs(rr.mean() - rt.mean()) < 0.05
        assert np.abs(ft.numpy() - ref)[vm].max() < 0.5
    assert int(dt.n_done) == int(dj.n_done)
    # padded vertices never move
    np.testing.assert_array_equal(ft.numpy()[~vm], a['positions'][~vm])


def test_cg_block_gather_tables_path_matches_plain_path(windowed_case):
    """Routing the gathers through K3 (tri, k-major ncc, fold by
    incidence, S) changes only summation order."""
    a, st = windowed_case
    g = tmd.gather_tables(st.ma)
    f0, d0 = tsw.cg_block(*port_args(st, 10.0), num_iters=4,
                          corr_method='windowed')
    f1, d1 = tsw.cg_block(*port_args(st, 10.0), num_iters=4,
                          corr_method='windowed', tables=g)
    vm = a['v_mask']
    assert np.abs(f1.numpy() - f0.numpy())[vm].max() < 1e-3
    np.testing.assert_allclose(d1.ress.numpy(), d0.ress.numpy(),
                               rtol=1e-4)
    np.testing.assert_array_equal(f1.numpy()[~vm], a['positions'][~vm])


def test_cg_block_face_hcgc_matches_pointside(windowed_case):
    """Face-side normal equations (K2 'ahw2' mode) reproduce the
    point-side subspace solve (tests/test_solver.py:410-433)."""
    a, st = windowed_case
    fp, _ = tsw.cg_block(*port_args(st, 10.0), num_iters=6,
                         corr_method='windowed')
    ff, _ = tsw.cg_block(*port_args(st, 10.0), num_iters=6,
                         corr_method='windowed', face_hcgc=True)
    vm = a['v_mask']
    assert np.abs(fp.numpy() - ff.numpy())[vm].max() < 0.05
    rp = np.linalg.norm(fp.numpy()[vm], axis=1)
    rf = np.linalg.norm(ff.numpy()[vm], axis=1)
    assert abs(rp.mean() - rf.mean()) < 0.01


def test_cg_block_active_iters_matches_shorter_block():
    """active_iters=k under a longer block equals a num_iters=k block
    (tests/test_solver.py:436-451)."""
    pts, sig = sphere_cloud(n=6000, seed=7)
    a, st = make_state(pts, sig, normalize='l2')
    f3, d3 = tsw.cg_block(*port_args(st, 10.0), num_iters=3)
    f63, d63 = tsw.cg_block(*port_args(st, 10.0), num_iters=6,
                            active_iters=3)
    np.testing.assert_allclose(f3.numpy(), f63.numpy(), rtol=0, atol=1e-6)
    assert int(d63.n_done) == 3
    assert np.isnan(d63.tests.numpy()[3:]).all()
    assert (d63.ress.numpy()[3:] == 0).all()


def test_cg_block_orthogonality_stop_freezes():
    """With a stop threshold every statistic passes, the block halts
    once three decreasing statistics are recorded, exactly as the JAX
    block does."""
    pts, sig = sphere_cloud(n=2000, seed=2)
    a, st = make_state(pts, sig, sub=2)
    fj, dj = jsw.cg_block(*jax_args(a, 10.0), num_iters=8, stop_eps=2.0)
    ft, dt = tsw.cg_block(*port_args(st, 10.0), num_iters=8, stop_eps=2.0)
    assert int(dt.n_done) == int(dj.n_done) < 8
    np.testing.assert_array_equal(np.isnan(dt.tests.numpy()),
                                  np.isnan(np.asarray(dj.tests)))
    vm = a['v_mask']
    assert np.abs(ft.numpy() - np.asarray(fj))[vm].max() < 0.5


def test_block_call_and_unported_options():
    """block_call is cg_block; the options that once raised here
    (use_shrink, want_curv_K) now run and follow the JAX block, and an
    spmd_mesh that is not a port DeviceMesh raises."""
    pts, sig = sphere_cloud(n=500)
    a, st = make_state(pts, sig, sub=2)
    f1, d1 = tsw.block_call(*port_args(st, 2.0), 0.0, num_iters=2,
                            active_iters=2, use_shrink=False,
                            face_chunk=512, corr_method='brute',
                            face_nbrs=st.ma.face_nbrs)
    f2, _ = tsw.cg_block(*port_args(st, 2.0), num_iters=2, face_chunk=512)
    np.testing.assert_array_equal(f1.numpy(), f2.numpy())
    assert d1.S.shape == (a['positions'].shape[0], 3, 3)
    vm = a['v_mask']
    for kw in ({'use_shrink': True}, {'want_curv_K': True}):
        if 'want_curv_K' in kw:
            tkw = dict(kw, nbr_f=st.ma.nbr_f)
            jkw = dict(kw, nbr_f=jnp.asarray(a['nbr_f']))
        else:
            tkw = jkw = kw
        ft, dt = tsw.cg_block(*port_args(st, 2.0), 1.0, num_iters=1,
                              face_chunk=512, **tkw)
        fj, dj = jsw.cg_block(*jax_args(a, 2.0), 1.0, num_iters=1,
                              face_chunk=512, **jkw)
        assert np.abs(ft.numpy() - np.asarray(fj))[vm].max() < 0.5
        assert dt.S.shape == np.asarray(dj.S).shape
        if 'want_curv_K' in kw:
            Kj = np.asarray(dj.K)[vm]
            np.testing.assert_allclose(dt.K.numpy()[vm], Kj, rtol=1e-3,
                                       atol=1e-3 * np.abs(Kj).max())
    # spmd_mesh is ported; a mesh that is not the port's DeviceMesh raises
    with pytest.raises(TypeError):
        tsw.cg_block(*port_args(st, 2.0), num_iters=1, spmd_mesh=object())
