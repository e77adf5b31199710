"""PyTorch port, nearest-face correspondence and K1's plain version,
held to the JAX package on the same numpy inputs.

K1's kernel (``csrc/window.cu``) runs only on a CUDA card; here its
plain version — what ``window_min`` runs on CPU tensors — is compared
with the JAX package's Pallas kernel in interpret mode, as the JAX
suite runs it (tests/test_solver.py:187-219 shapes).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu.ops.pallas_kernels import window_min_pallas

from ch_shrinkwrap_torch.ops import correspondence as tcorr
from ch_shrinkwrap_torch.ops import cuda_window

from chip_smoke import k1_lattice_case, k1_tie_cases

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def problem():
    """icosphere(4) faces and a Hilbert-sorted noisy sphere cloud with
    uniform background (the JAX suite's windowed-kernel fixture)."""
    rng = np.random.default_rng(7)
    v, f = icosphere(4, radius=50.0)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    centers = np.asarray(ma.positions)[np.asarray(ma.faces)].mean(1)
    d = rng.normal(size=(4000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = d * 50.0 + rng.normal(scale=3.0, size=d.shape)
    far = rng.uniform(-150, 150, (200, 3))
    allp = np.vstack([pts, far]).astype(np.float32)
    allp = allp[jcorr.fit_point_order(allp)]
    return dict(ma=ma, centers=centers.astype(np.float32),
                f_mask=np.asarray(ma.f_mask),
                face_nbrs=np.asarray(ma.face_nbrs), pts=allp)


def test_window_min_plain_matches_pallas_interpret(problem):
    """Equal face ids and subsample slots, d^2 to 1e-5 relative."""
    pts, centers, fm = problem['pts'], problem['centers'], problem['f_mask']
    W = 1024
    starts = np.asarray(jcorr.windowed_anchor_starts(
        jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(fm), window=W))
    prep = jcorr.windowed_points_prep(jnp.asarray(pts))
    c2 = np.where(fm, (centers * centers).sum(-1), 3.4e38).astype(
        np.float32)
    sub = np.asarray(jcorr._subsample_ids(centers.shape[0], 1024))
    d2j, fj, jj = map(np.asarray, window_min_pallas(
        prep.blocks_t, jnp.asarray(starts), jnp.asarray(centers.T),
        jnp.asarray(c2), jnp.asarray(sub), window=W, n_anchors=3,
        interpret=True))
    d2t, ft, jt = cuda_window.window_min(
        t(prep.blocks_t), t(starts), t(centers.T), t(c2), t(sub), window=W)
    assert cuda_window.window_min.launches == 0     # CPU -> plain
    np.testing.assert_array_equal(ft.numpy(), fj)
    np.testing.assert_array_equal(jt.numpy(), jj)
    np.testing.assert_allclose(d2t.numpy(), d2j, rtol=0,
                               atol=1e-5 * np.abs(d2j).max())
    # some points won through the subsample (the far background)
    assert (jt.numpy() > 0).any()
    assert jt.dtype == torch.int32 and ft.dtype == torch.int32


def test_windowed_anchor_starts_match_jax(problem):
    pts, centers, fm = problem['pts'], problem['centers'], problem['f_mask']
    for W in (1024, 2048):
        sj = np.asarray(jcorr.windowed_anchor_starts(
            jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(fm),
            window=W))
        st = tcorr.windowed_anchor_starts(t(pts), t(centers), t(fm),
                                          window=W).numpy()
        np.testing.assert_array_equal(st, sj)


def test_windowed_matches_bruteforce_bounds(problem):
    """The port's windowed search against its exact brute force, at the
    JAX suite's bounds (tests/test_solver.py:216-219)."""
    pts, centers, fm = problem['pts'], problem['centers'], problem['f_mask']
    d_b, i_b = tcorr.nearest_face_bruteforce(t(pts), t(centers), t(fm))
    d_p, i_p, meta = tcorr.nearest_face_windowed(
        t(pts), t(centers), t(fm), window=1024, return_meta=True)
    i_b, i_p, d_b, d_p = i_b.numpy(), i_p.numpy(), d_b.numpy(), d_p.numpy()
    assert (i_p == i_b).mean() > 0.85
    assert np.all(d_p >= d_b * 0.99 - 0.05)
    assert np.abs(d_p - d_b).mean() < 1.0
    assert np.abs(d_p - d_b).max() < 10.0
    assert meta.starts.shape == (-(-len(pts) // 256), 3)
    assert (meta.starts.numpy() % 128 == 0).all()
    assert meta.js.shape == (len(pts),)


def test_windowed_meta_matches_jax_pallas(problem):
    pts, centers, fm = problem['pts'], problem['centers'], problem['f_mask']
    dj, fj, mj = jcorr.nearest_face_windowed(
        jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(fm),
        window=1024, use_pallas=True, pallas_interpret=True,
        return_meta=True)
    dt, ft, mt = tcorr.nearest_face_windowed(
        t(pts), t(centers), t(fm), window=1024, return_meta=True)
    # |c|^2 and |p|^2 are rounded as XLA rounds them (sumsq3), and K1's
    # plain version is equal on equal inputs, so every id agrees
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(mt.starts.numpy(), np.asarray(mj.starts))
    np.testing.assert_array_equal(mt.js.numpy(), np.asarray(mj.js))
    np.testing.assert_array_equal(mt.sub_ids.numpy(),
                                  np.asarray(mj.sub_ids))
    # d^2 = (|c|^2 - 2 p.c) + |p|^2 carries a few ulps of |p|^2
    np.testing.assert_allclose(dt.numpy() ** 2, np.asarray(dj) ** 2,
                               rtol=1e-5, atol=2e-3)


def test_bruteforce_matches_jax(problem):
    pts, centers, fm = problem['pts'], problem['centers'], problem['f_mask']
    fm = fm.copy()
    fm[100:140] = False
    dj, ij = jcorr.nearest_face_bruteforce(
        jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(fm),
        face_chunk=1024)
    dt, it = tcorr.nearest_face_bruteforce(t(pts), t(centers), t(fm),
                                           face_chunk=1024,
                                           point_block=1000)
    assert (it.numpy() == np.asarray(ij)).mean() > 0.999
    assert not np.isin(it.numpy(), np.arange(100, 140)).any()
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-4,
                               atol=1e-3)


def test_refine_and_operators_match_jax(problem):
    pts, centers = problem['pts'], problem['centers']
    ma = problem['ma']
    fid0 = np.asarray(jcorr.nearest_face_windowed(
        jnp.asarray(pts), jnp.asarray(centers), ma.f_mask, window=1024)[1])
    dj, fj = jcorr.refine_correspondence(
        jnp.asarray(pts), jnp.asarray(centers), ma.face_nbrs,
        jnp.asarray(fid0), n_iter=2)
    dt, ft = tcorr.refine_correspondence(
        t(pts), t(centers), t(problem['face_nbrs']), t(fid0), n_iter=2)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-4)

    pos, faces = np.asarray(ma.positions), np.asarray(ma.faces)
    vj, wj = jcorr.correspondence_weights(ma.positions, ma.faces,
                                          jnp.asarray(pts), fj)
    vt, wt = tcorr.correspondence_weights(t(pos), t(faces), t(pts), ft)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)
    rng = np.random.default_rng(0)
    x = rng.normal(size=pos.shape).astype(np.float32)
    r = rng.normal(size=pts.shape).astype(np.float32)
    np.testing.assert_allclose(
        tcorr.a_apply(t(x), vt, wt).numpy(),
        np.asarray(jcorr.a_apply(jnp.asarray(x), vj, wj)), rtol=1e-5,
        atol=1e-5)
    Ahr_t = tcorr.ah_apply(t(r), vt, wt, pos.shape[0]).numpy()
    np.testing.assert_allclose(
        Ahr_t, np.asarray(jcorr.ah_apply(jnp.asarray(r), vj, wj,
                                         pos.shape[0])),
        rtol=1e-5, atol=1e-4)
    # a true adjoint pair
    lhs = float((tcorr.a_apply(t(x), vt, wt).numpy() * r).sum())
    np.testing.assert_allclose(lhs, float((x * Ahr_t).sum()), rtol=1e-4)


@pytest.mark.parametrize('seed', [0, 1])
def test_sumsq3_matches_jitted_xla(seed):
    """|c|^2 as the windowed path forms it is bit-equal to the JAX
    package's jitted ``where(m, (c * c).sum(-1), BIG)`` (an FMA chain
    in XLA), over centres of fit scale, tiny and huge magnitudes."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.normal(size=(20000, 3)) * 500.0,
                        rng.normal(size=(2000, 3)) * 1e-3,
                        rng.normal(size=(2000, 3)) * 1e15]).astype(
                            np.float32)
    m = rng.random(c.shape[0]) > 0.1
    ref = np.asarray(jax.jit(lambda c_, m_: jnp.where(
        m_, (c_ * c_).sum(-1), 3.4e38))(c, m))
    out = tcorr._masked_c2(t(c), t(m)).numpy()
    np.testing.assert_array_equal(out, ref)
    p2 = np.asarray(jax.jit(lambda c_: (c_ * c_).sum(-1))(c))
    np.testing.assert_array_equal(tcorr.sumsq3(t(c)).numpy(), p2)
    # torch's own sum rounds differently on some rows (why sumsq3 exists)
    assert ((t(c) * t(c)).sum(-1).numpy() != p2).any()


def test_window_min_ties_take_first_index():
    """Exact ties (across windows, window against subsample, two
    subsample slots, inside one window) go to the first minimum in
    concatenation order, in K1's plain version and in the JAX Pallas
    kernel alike; and on an integer lattice, where ties are everywhere,
    the two agree on every id.  The card half is in test_torch_cuda."""
    for name, args, fid, js in k1_tie_cases('cpu'):
        _, f_t, j_t = cuda_window.window_min(*args)
        assert (f_t == fid).all() and (j_t == js).all(), name
        blocks_t, starts, centers_t, c2, sub, W, A = args
        _, f_j, j_j = window_min_pallas(
            jnp.asarray(blocks_t.numpy()), jnp.asarray(starts.numpy()),
            jnp.asarray(centers_t.numpy()), jnp.asarray(c2.numpy()),
            jnp.asarray(sub.numpy()), window=W, n_anchors=A,
            interpret=True)
        assert (np.asarray(f_j) == fid).all(), name
        assert (np.asarray(j_j) == js).all(), name
    lat = k1_lattice_case('cpu', nb=8)
    d_t, f_t, j_t = cuda_window.window_min(*lat)
    blocks_t, starts, centers_t, c2, sub, W, A = lat
    d_j, f_j, j_j = map(np.asarray, window_min_pallas(
        *(jnp.asarray(a.numpy()) for a in (blocks_t, starts, centers_t,
                                            c2, sub)),
        window=W, n_anchors=A, interpret=True))
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    np.testing.assert_array_equal(j_t.numpy(), j_j)
    np.testing.assert_array_equal(d_t.numpy(), d_j)
