"""PyTorch port, the hash-grid and blocked nearest-face searches held to
the JAX package's ``nearest_face_grid`` / ``nearest_face_blocked``.

Both are plain tensor code in both packages.  The port forms the
squared distances in XLA's rounding (FMA chains through ``fma_f32``),
so the face ids are equal; the distances are within one ulp because
torch.sqrt on the CPU is not correctly rounded.  Solver and fit bounds
are the JAX suite's (tests/test_solver.py:403-404).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.solver import shrinkwrap as jsw

from ch_shrinkwrap_torch.convert import state_from_numpy
from ch_shrinkwrap_torch.models import MembraneMesh as TMesh
from ch_shrinkwrap_torch.ops import correspondence as tcorr
from ch_shrinkwrap_torch.ops.ordering import fit_point_order
from ch_shrinkwrap_torch.solver import shrinkwrap as tsw

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def sphere_case():
    """tests/test_solver.py:38-54: icosphere(4) at R = 50 and 5000
    points within a few nm of it."""
    rng = np.random.default_rng(3)
    v, f = icosphere(4, radius=50.0)
    mesh = TriangleMesh(v, f)
    ma = jmd.from_mesh(mesh, quantum=256)
    centers = np.asarray(ma.positions)[np.asarray(ma.faces)].mean(1)
    d = rng.normal(size=(5000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50.0 + rng.normal(scale=3.0, size=d.shape)).astype(np.float32)
    return dict(pts=pts, centers=centers, f_mask=np.asarray(ma.f_mask),
                cell=2.0 * mesh._mean_edge_length, dirs=d)


def test_grid_matches_jax(sphere_case):
    c = sphere_case
    args = (c['pts'], c['centers'], c['f_mask'])
    dj, ij = jcorr.nearest_face_grid(*map(jnp.asarray, args), c['cell'])
    dt, it = tcorr.nearest_face_grid(*map(t, args), c['cell'])
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)
    # the JAX suite's bounds against the exact search
    db, ib = tcorr.nearest_face_bruteforce(*map(t, args))
    assert np.mean(ib.numpy() == it.numpy()) > 0.98
    assert np.abs(dt.numpy() - db.numpy()).max() < c['cell']
    # far points through the subsample fallback
    far = (c['dirs'][:100] * 200.0).astype(np.float32)
    dj2, ij2 = jcorr.nearest_face_grid(
        jnp.asarray(far), jnp.asarray(c['centers']),
        jnp.asarray(c['f_mask']), c['cell'])
    dt2, it2 = tcorr.nearest_face_grid(t(far), t(c['centers']),
                                       t(c['f_mask']), c['cell'])
    np.testing.assert_array_equal(it2.numpy(), np.asarray(ij2))
    # the dispatcher: the grid with a cell size, else the brute force
    _, i_d = tcorr.nearest_face(*map(t, args), cell_size=c['cell'])
    np.testing.assert_array_equal(i_d.numpy(), it.numpy())
    _, i_d = tcorr.nearest_face(*map(t, args), face_chunk=1024)
    np.testing.assert_array_equal(i_d.numpy(), ib.numpy())
    np.testing.assert_array_equal(i_d.numpy(), np.asarray(jcorr.nearest_face(
        *map(jnp.asarray, args), face_chunk=1024)[1]))


def test_blocked_matches_jax(sphere_case):
    c = sphere_case
    pts = c['pts'][fit_point_order(c['pts'])]
    fm = c['f_mask'].copy()
    fm[100:140] = False
    args = (pts, c['centers'], fm)
    dj, ij = jcorr.nearest_face_blocked(*map(jnp.asarray, args))
    dt, it = tcorr.nearest_face_blocked(*map(t, args))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)
    assert not np.isin(it.numpy(), np.arange(100, 140)).any()
    _, ib = tcorr.nearest_face_bruteforce(*map(t, args))
    assert np.mean(ib.numpy() == it.numpy()) > 0.98


def test_cell_hash_matches_jax():
    """int32 wrap, abs(INT_MIN) and floor-mod, on cells that overflow
    every product and on the cell whose hash is INT_MIN."""
    rng = np.random.default_rng(0)
    cells = rng.integers(-2 ** 31, 2 ** 31, size=(4096, 3)).astype(np.int32)
    cells[:64] = rng.integers(-40, 40, size=(64, 3))
    # 73856093 * x wraps to INT_MIN for this x, and 0 XOR 0 leaves it
    x = np.int32(np.uint32((2 ** 31 * pow(73856093, -1, 2 ** 32))
                           % 2 ** 32).view(np.int32))
    cells[64] = (x, 0, 0)
    jh = np.asarray(jcorr._cell_hash(*(jnp.asarray(cells[:, k])
                                       for k in range(3)), 1 << 18))
    th = tcorr._cell_hash(t(cells), 1 << 18).numpy()
    np.testing.assert_array_equal(th, jh)
    assert (th >= 0).all() and (th < 1 << 18).all()


def test_grid_tie_order_matches_jax():
    """Points and face centres on an integer lattice: many candidates
    at exactly equal distances, in one cell and across cells.  The port
    takes the same face as the JAX package on every point (stable hash
    order, first minimum in a cell, strict improvement across cells)."""
    g = np.arange(-4, 5, dtype=np.float32)
    centers = np.stack(np.meshgrid(g, g, g, indexing='ij'), -1).reshape(-1, 3)
    centers = np.concatenate([centers, centers[:50]])   # duplicate faces
    fm = np.ones(len(centers), bool)
    rng = np.random.default_rng(1)
    pts = (rng.integers(-8, 9, size=(2000, 3)) * 0.5).astype(np.float32)
    for cell in (1.0, 2.0, 3.0):
        _, ij = jcorr.nearest_face_grid(jnp.asarray(pts),
                                        jnp.asarray(centers),
                                        jnp.asarray(fm), cell, cell_cap=8)
        _, it = tcorr.nearest_face_grid(t(pts), t(centers), t(fm), cell,
                                        cell_cap=8)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_smallest_k_breaks_ties_like_top_k():
    """The k-th value tied past k: the lowest ids win, as in
    ``jax.lax.top_k`` of the negated rows."""
    d = np.array([[3, 1, 2, 2, 2, 0, 2],
                  [5, 5, 5, 5, 5, 5, 5],
                  [0, 1, 1, 0, 1, 1, 0]], np.float32)
    for k in (1, 2, 3, 4, 6):
        _, jk = jax.lax.top_k(-jnp.asarray(d), k)
        tk = tcorr._smallest_k(t(d), k)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_blocked_medians_and_ties_match_jax():
    """Block centroids are the mean of the two middle values (as
    ``jnp.median``, not ``torch.median``'s lower one), and faces at equal
    distances from several block centroids join the same tables."""
    rng = np.random.default_rng(2)
    blocks = (rng.integers(-20, 20, size=(17, 256, 3)) * 0.25).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcorr.block_centroids(t(blocks)).numpy(),
        np.asarray(jnp.median(jnp.asarray(blocks), axis=1)))
    assert not torch.equal(tcorr.block_centroids(t(blocks)),
                           torch.median(t(blocks), dim=1).values)
    # lattice blocks and faces: many equal block-centroid distances
    pts = np.repeat(np.stack(np.meshgrid(
        np.arange(4), np.arange(5), np.arange(1), indexing='ij'),
        -1).reshape(-1, 3).astype(np.float32) * 4.0, 256, axis=0)
    pts = pts + (rng.integers(-1, 2, size=pts.shape) * 0.5).astype(
        np.float32)
    g = np.arange(-2, 18, 2, dtype=np.float32)
    centers = np.stack(np.meshgrid(g, g, np.array([0.0, 2.0], np.float32),
                                   indexing='ij'), -1).reshape(-1, 3)
    fm = np.ones(len(centers), bool)
    for cap in (2048, 24):
        dj, ij = jcorr.nearest_face_blocked(
            jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(fm),
            cand_cap=cap, n_subsample=16)
        dt, it = tcorr.nearest_face_blocked(t(pts), t(centers), t(fm),
                                            cand_cap=cap, n_subsample=16)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def make_state(n=4096, seed=3, sort=True):
    """tests/test_solver.py:384-399's block inputs, at half the
    points."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50 + rng.normal(scale=5.0, size=(n, 3))).astype(np.float32)
    if sort:
        pts = np.ascontiguousarray(pts[fit_point_order(pts)])
    sig = np.full((n, 3), 5.0, np.float32)
    v, f = icosphere(3, radius=60.0)
    mesh = TriangleMesh(v, f)
    ma = jmd.from_mesh(mesh, quantum=256)
    sigma_inv = (1.0 / sig).astype(np.float32)
    weights = (sigma_inv / np.sqrt((sigma_inv ** 2).sum())).astype(
        np.float32)
    a = dict(positions=np.asarray(ma.positions),
             v_mask=np.asarray(ma.v_mask), faces=np.asarray(ma.faces),
             f_mask=np.asarray(ma.f_mask), nbr_v=np.asarray(ma.nbr_v),
             points=pts, sigma_inv=sigma_inv, weights=weights,
             point_mask=np.ones(n, bool))
    return a, state_from_numpy(device='cpu', **a), mesh._mean_edge_length


@pytest.mark.parametrize('method', ['grid', 'blocked'])
def test_cg_block_grid_blocked_match_jax(method):
    a, st, mel = make_state()
    keys = ('positions', 'faces', 'f_mask', 'v_mask', 'nbr_v', 'points',
            'sigma_inv', 'weights', 'point_mask')
    kw = dict(num_iters=3, corr_method=method, cell_size=2.0 * mel)
    fj, dj = jsw.cg_block(*(jnp.asarray(a[k]) for k in keys), 10.0, **kw)
    ma = st.ma
    ft, dt = tsw.cg_block(ma.positions, ma.faces, ma.f_mask, ma.v_mask,
                          ma.nbr_v, st.points, st.sigma_inv, st.weights,
                          st.point_mask, 10.0, **kw)
    vm = a['v_mask']
    rj = np.linalg.norm(np.asarray(fj)[vm], axis=1)
    rt = np.linalg.norm(ft.numpy()[vm], axis=1)
    assert abs(rj.mean() - rt.mean()) < 0.05
    assert np.abs(np.asarray(fj) - ft.numpy())[vm].max() < 0.5
    assert int(dt.n_done) == int(dj.n_done)


@pytest.mark.parametrize('method,n', [('grid', 1500), ('blocked', 4096)])
def test_fit_grid_blocked_match_jax(method, n):
    """10 iterations with a remesh at 5: the fit passes 2 x the mean
    edge as the grid's cell and sorts the cloud for the blocked search,
    as the JAX package's fit does; R within 0.1 nm of the JAX fit.  The
    blocked search needs 16 blocks of 256 points (its face_k)."""
    rng = np.random.default_rng(4)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50 + rng.normal(scale=3, size=(n, 3))).astype(np.float32)
    v, f = icosphere(2, radius=60.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=5,
              delaunay_remesh_frequency=0, neck_first_iter=-1)
    jm = JMesh(v, f, **kw)
    jm.corr_method = method
    jm.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=10.0)
    tm = TMesh(v, f, device='cpu', **kw)
    tm.corr_method = method
    tm.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=10.0)
    assert tm._last_corr_method == jm._last_corr_method == method
    rj = np.linalg.norm(jm.vertices, axis=1).mean()
    rt = np.linalg.norm(tm.vertices, axis=1).mean()
    assert abs(rt - rj) < 0.1
    assert tm.euler_characteristic == 2 and tm.is_manifold
