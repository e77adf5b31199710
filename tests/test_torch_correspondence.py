"""PyTorch port, nearest-face correspondence and K1's plain version,
held to the JAX package on the same numpy inputs.

K1's kernel (``csrc/window.cu``) runs only on a CUDA card; here its
plain version — what ``window_min`` runs on CPU tensors — is compared
with the JAX package's Pallas kernel in interpret mode, as the JAX
suite runs it (tests/test_solver.py:187-219 shapes).
"""

from fractions import Fraction

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
from ch_shrinkwrap_torch.utils.math import fma_f32

from chip_smoke import k1_boundary_cases, k1_lattice_case, k1_tie_cases

from torch_parity_native import load_both_engines

load_both_engines()
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
    """Equal face ids and subsample slots, and bit-equal d^2: the plain
    version forms XLA's FMA chain for the dot product."""
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
    np.testing.assert_array_equal(d2t.numpy().view(np.int32),
                                  d2j.view(np.int32))
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
    # d = sqrt(max(d2 + |p|^2, 0)): the squared distance is bit-equal
    # to XLA's, so a correctly rounded root of it is XLA's d bit for bit
    prep = tcorr.windowed_points_prep(t(pts))
    d2k = cuda_window.window_min(
        prep.blocks_t, mt.starts, t(centers.T), tcorr._masked_c2(
            t(centers), t(fm)), mt.sub_ids, window=1024)[0]
    d2f = (d2k + prep.p2).reshape(-1)[:len(pts)].numpy()
    np.testing.assert_array_equal(np.sqrt(np.maximum(d2f, 0.0)),
                                  np.asarray(dj))
    # torch.sqrt on the CPU (its vectorised float path) is not correctly
    # rounded and misses by one ulp on some rows
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)


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
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert not np.isin(it.numpy(), np.arange(100, 140)).any()
    # the squared distances are XLA's (sumsq3 and the FMA dot), so the
    # ids are equal by construction; torch.sqrt on the CPU is not
    # correctly rounded and misses by one ulp on some rows
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)


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


def midpoint_rows(rng, n):
    """(n + 1, 3) f32 rows whose squared sums fall near an f32 midpoint,
    where adding in float64 and then rounding to f32 rounds twice: one
    coordinate an odd integer 2049..8191 times 2^-6 (a 13-bit
    significand), another below 1e-4 in magnitude; plus the row
    (1e-5, 4097, 0)."""
    y = (2 * rng.integers(1024, 4096, n) + 1) * 2.0 ** -6
    x = rng.uniform(-1e-4, 1e-4, n)
    rows = np.zeros((n, 3))
    col = rng.integers(0, 3, n)
    rows[np.arange(n), col] = y
    rows[np.arange(n), (col + 1 + rng.integers(0, 2, n)) % 3] = x
    return np.vstack([rows, [[1e-5, 4097.0, 0.0]]]).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_sumsq3_matches_jitted_xla(seed):
    """|c|^2 as the windowed path forms it is bit-equal to the JAX
    package's jitted ``where(m, (c * c).sum(-1), BIG)`` (an FMA chain
    in XLA), over centres of fit scale, tiny and huge magnitudes, and
    rows whose sums fall near an f32 midpoint (one rounding per FMA)."""
    rng = np.random.default_rng(seed)
    c = np.concatenate([rng.normal(size=(20000, 3)) * 500.0,
                        rng.normal(size=(2000, 3)) * 1e-3,
                        rng.normal(size=(2000, 3)) * 1e15,
                        midpoint_rows(rng, 50000)]).astype(np.float32)
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
    the two agree on every id.  The boundary cases are here too, on
    the seams of a small schedule: neither version has seams of its own,
    and the card half (test_torch_cuda) places them on the built
    kernel's, which only its library can report."""
    for name, args, fid, js in (*k1_tie_cases('cpu'),
                                *k1_boundary_cases('cpu', (512, 128, 4))):
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


def test_fma_dot3_matches_jitted_dot_general():
    """K1's dot product, ``fma(z, Z, fma(y, Y, x * X))`` through
    ``fma_f32``, is bit-equal to the JAX package's jitted K = 3
    ``dot_general`` of (3, B) points and (3, n) centres at fit scale,
    midpoint rows included; the unfused sum is not."""
    rng = np.random.default_rng(3)
    B, n = 256, 4096
    P = (rng.normal(size=(3, B)) * 500.0).astype(np.float32)
    C = (rng.normal(size=(3, n)) * 500.0).astype(np.float32)
    mid = midpoint_rows(rng, 2000)
    P[:, :128] = mid[:128].T
    C[:, :1024] = mid[-1024:].T
    ref = np.asarray(jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))(P, C))
    px, py, pz = (t(P[k])[:, None] for k in range(3))
    cx, cy, cz = (t(C[k])[None, :] for k in range(3))
    out = fma_f32(pz, cz, fma_f32(py, cy, px * cx)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert (((px * cx + py * cy) + pz * cz).numpy() != ref).any()
    # the pre-scaled table of K1: c2 + fma(z, -2Z, fma(y, -2Y, x * -2X))
    # is bit-equal to c2 - 2 * dot
    c2 = tcorr.sumsq3(t(C.T))[None, :]
    scaled = c2 + fma_f32(pz, -2.0 * cz, fma_f32(py, -2.0 * cy,
                                                 px * (-2.0 * cx)))
    np.testing.assert_array_equal(scaled.numpy(),
                                  (c2 - 2.0 * t(out)).numpy())


def _rn32(q):
    """The float32 nearest to the rational q, ties to even (exact)."""
    if abs(q) >= 2 ** 128 - 2 ** 103:     # FLT_MAX + half an ulp
        return np.float32(np.inf if q > 0 else -np.inf)
    f = np.float32(np.clip(float(q), -3.4028234663852886e38,
                           3.4028234663852886e38))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    cands = [x for x in cands if np.isfinite(x)]
    best = min(abs(Fraction(float(x)) - q) for x in cands)
    ties = [x for x in cands if abs(Fraction(float(x)) - q) == best]
    if len(ties) == 1:
        return ties[0]
    return next(x for x in ties if not np.array([x]).view(np.int32)[0] & 1)


@pytest.mark.parametrize('kind', ['random', 'midpoint', 'cancel',
                                  'subnormal', 'huge'])
def test_fma_f32_is_correctly_rounded(kind):
    """``fma_f32`` against the exact product-sum rounded once to
    float32 (Python fractions), where a float64 sum rounded to float32
    rounds twice: on float32 midpoints, under cancellation, in the
    subnormal range and near the float32 overflow threshold."""
    rng = np.random.default_rng(11)
    n = 3000
    if kind == 'random':
        a, b, c = (rng.normal(size=n) * 10.0 ** rng.integers(-8, 9, n)
                   for _ in range(3))
    elif kind == 'midpoint':
        m = midpoint_rows(rng, n - 1)
        a, b, c = m[:, 1], m[:, 1], m[:, 0] * m[:, 0]
    elif kind == 'cancel':
        a = rng.normal(size=n) * 50.0
        b = rng.normal(size=n) * 50.0
        c = -(a.astype(np.float32).astype(np.float64)
              * b.astype(np.float32)) * (1 + rng.normal(size=n) * 1e-6)
    elif kind == 'subnormal':
        a = rng.normal(size=n) * 1e-20
        b = rng.normal(size=n) * 1e-19
        c = rng.normal(size=n) * 1e-39
    else:
        a = rng.normal(size=n) * 1.8e19
        b = rng.normal(size=n) * 1.8e19
        c = rng.uniform(-3.4e38, 3.4e38, n)
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    out = fma_f32(t(a), t(b), t(c)).numpy()
    ref = np.array([_rn32(Fraction(float(x)) * Fraction(float(y))
                          + Fraction(float(z)))
                    for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
