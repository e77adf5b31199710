"""PyTorch port, multi-device fits over torch.distributed, held to the
JAX package's ``parallel/sharding.py``.

Ranks are spawned processes on the CPU (gloo), each group with its own
FileStore and a 60 s timeout.  Bounds are the JAX suite's
(tests/test_parallel.py:37-38 and :72-77).  The JAX side runs on two
of the suite's virtual CPU devices.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.parallel import sharding as jsh
from ch_shrinkwrap_tpu.solver import shrinkwrap as jsw

from ch_shrinkwrap_torch.convert import state_from_numpy
from ch_shrinkwrap_torch.models import MembraneMesh as TMesh
from ch_shrinkwrap_torch.ops.ordering import fit_point_order
from ch_shrinkwrap_torch.parallel import sharding as tsh
from ch_shrinkwrap_torch.solver import shrinkwrap as tsw

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

TIMEOUT_S = 60.0


def cpu_mesh(n=2):
    return tsh.make_device_mesh(n, devices=['cpu'] * n, timeout_s=TIMEOUT_S)


def problem(n=1600, seed=0, sort=False):
    """tests/test_parallel.py:16-25, as numpy and as the port's state."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50 + rng.normal(scale=3, size=(n, 3))).astype(np.float32)
    if sort:
        pts = np.ascontiguousarray(pts[fit_point_order(pts)])
    sigma_inv = np.full((n, 3), 1 / 3, np.float32)
    weights = sigma_inv / sigma_inv.mean()
    v, f = icosphere(2, radius=60.0)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    arrays = {k: np.asarray(getattr(ma, k)) for k in (
        'positions', 'v_mask', 'faces', 'f_mask', 'nbr_v', 'nbr_f',
        'face_nbrs')}
    return ma, state_from_numpy(device='cpu', **arrays), pts, sigma_inv, \
        weights


def sphere_fixture(n=4000):
    """tests/test_parallel.py:53-57."""
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    return (d * 50 + rng.normal(scale=3, size=(n, 3))).astype(np.float32)


@pytest.mark.parametrize('method,n', [('brute', 1600), ('windowed', 2000)])
def test_sharded_block_matches_jax_and_one_process(method, n):
    """The port's 2-rank block against the JAX package's 2-device
    sharded block and its one-device block (positions within 5e-3,
    n_done equal), and against its own one-process block: the
    first-iteration face ids and distances are equal, because every
    rank searches whole 256-point blocks of the same sorted cloud."""
    jma, st, pts, sig, w = problem(n, sort=method == 'windowed')
    ma = st.ma
    kw = dict(lam0=2.0, num_iters=3, face_chunk=256, corr_method=method,
              face_nbrs=ma.face_nbrs)
    f2, d2 = tsh.sharded_cg_block(cpu_mesh(), ma, pts, sig, w, **kw)
    assert int(d2.n_done) == 3

    jmesh = jsh.make_device_mesh(2)
    p, s, ww, m = jsh.shard_points(jmesh, pts, sig, w)
    fjs, djs = jsh.sharded_cg_block(jmesh, jma, p, s, ww, m, lam0=2.0,
                                    num_iters=3, face_chunk=256,
                                    corr_method=method,
                                    face_nbrs=jma.face_nbrs)
    fj1, _ = jsw.cg_block(
        jma.positions, jma.faces, jma.f_mask, jma.v_mask, jma.nbr_v,
        jnp.asarray(pts), jnp.asarray(sig), jnp.asarray(w),
        jnp.ones(n, bool), 2.0, num_iters=3, face_chunk=256,
        corr_method=method, face_nbrs=jma.face_nbrs)
    assert int(djs.n_done) == 3
    np.testing.assert_allclose(f2.numpy(), np.asarray(fjs), atol=5e-3)
    np.testing.assert_allclose(f2.numpy(), np.asarray(fj1), atol=5e-3)

    args = (ma.positions, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
            torch.from_numpy(pts), torch.from_numpy(sig),
            torch.from_numpy(w), torch.ones(n, dtype=torch.bool), 2.0)
    f1, d1 = tsw.cg_block(*args, **{k: v for k, v in kw.items()
                                    if k != 'lam0'})
    np.testing.assert_allclose(f2.numpy(), f1.numpy(), atol=5e-3)
    kw1 = dict(kw, num_iters=1)
    _, e2 = tsh.sharded_cg_block(cpu_mesh(), ma, pts, sig, w, **kw1)
    _, e1 = tsw.cg_block(*args, **{k: v for k, v in kw1.items()
                                   if k != 'lam0'})
    assert e2.fi.shape[0] == 2 * 256 * -(-n // 512)
    np.testing.assert_array_equal(e2.fi[:n].numpy(), e1.fi.numpy())
    np.testing.assert_array_equal(e2.d[:n].numpy(), e1.d.numpy())
    np.testing.assert_array_equal(e2.res[:n].numpy(), e1.res.numpy())
    # the pad rows repeat the last point and carry no residual
    assert float(e2.res[n:].abs().max()) == 0.0
    if method == 'windowed':
        # the face-side normal equations: W2 is all-reduced with A^T
        kw2 = dict(kw, face_hcgc=True)
        f2h, _ = tsh.sharded_cg_block(cpu_mesh(), ma, pts, sig, w, **kw2)
        f1h, _ = tsw.cg_block(*args, **{k: v for k, v in kw2.items()
                                        if k != 'lam0'})
        np.testing.assert_allclose(f2h.numpy(), f1h.numpy(), atol=5e-3)
        assert np.abs(f2h.numpy() - f2.numpy()).max() < 0.05


def test_sharded_fit_matches_one_process_and_jax():
    """The whole fit over 2 ranks (tests/test_parallel.py:44-77): the
    sphere is recovered, within 1.0 nm of the port's one-process fit and
    of the JAX package's 2-device sharded fit; the diagnostics come back
    at full length and the method is kept."""
    pts = sphere_fixture()
    v, f = icosphere(2, radius=65.0)
    kw = dict(kc=1.0, step_size=5.0, remesh_frequency=3,
              delaunay_remesh_frequency=0, neck_first_iter=-1)
    fit_kw = dict(max_iter=6, minimum_edge_length=8.0)
    one = TMesh(v.copy(), f.copy(), device='cpu', **kw)
    one.shrink_wrap(pts, 3.0, **fit_kw)
    m = TMesh(v.copy(), f.copy(), device='cpu', **kw)
    m.corr_method = 'windowed'
    tsh.sharded_fit(m, pts, 3.0, n_devices=2, **fit_kw)
    jm = JMesh(v.copy(), f.copy(), **kw)
    jsh.sharded_fit(jm, pts, 3.0, n_devices=2, **fit_kw)
    r = np.linalg.norm(m.vertices, axis=1).mean()
    assert abs(r - 50.0) < 2.5
    assert abs(r - np.linalg.norm(one.vertices, axis=1).mean()) < 1.0
    assert abs(r - np.linalg.norm(jm.vertices, axis=1).mean()) < 1.0
    assert m.euler_characteristic == 2
    assert m.is_manifold
    # no silent downgrade of the production method
    assert m._last_corr_method == 'windowed'
    assert m.device_mesh.world_size == 2
    V = m.vertices.shape[0]
    assert m._last_diag.res.shape == (len(pts), 3)
    assert m._last_diag.d.shape == (len(pts),)
    assert m.point_dis.shape == m.rms_point_sc.shape == (V,)
    assert np.isfinite(m.rms_point_sc).all()
    counts, _, _ = m.residual_histogram()
    assert np.isfinite(counts).all()
    assert m.distance_to_surface(pts).shape == (len(pts),)


def test_ranks_out_of_step_raise():
    """A (V, F) mismatch between ranks raises on every rank within the
    group's timeout instead of hanging."""
    v, f = icosphere(1, radius=10.0)
    mesh = cpu_mesh()
    with pytest.raises(RuntimeError, match='out of step'):
        tsh.run_ranks(mesh, lambda: tsh.check_in_step(mesh, v, f),
                      tsh.check_in_step, (mesh, v[:-1], f))
    # and identical ranks pass
    tsh.run_ranks(mesh, lambda: tsh.check_in_step(mesh, v, f),
                  tsh.check_in_step, (mesh, v, f))


def test_worker_failure_surfaces():
    """An exception on a spawned rank reaches rank 0 with its
    traceback."""
    with pytest.raises(RuntimeError, match='rank 1'):
        tsh.run_ranks(cpu_mesh(), lambda: None, tsh.make_device_mesh,
                      (3, ['cpu']))


def test_device_mesh_contract():
    """make_device_mesh follows the JAX contract (no silent
    truncation), picks gloo for CPU ranks and shared cards, and pads the
    cloud by repeating its last point."""
    with pytest.raises(ValueError):
        tsh.make_device_mesh(3, devices=['cpu', 'cpu'])
    with pytest.raises(ValueError):
        tsh.make_device_mesh(10 ** 4, devices=['cpu'] * 10 ** 4)
    with pytest.raises(ValueError):
        tsh.make_device_mesh(2, devices=['cpu', 'cuda:0'])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError):
            tsh.make_device_mesh(2)
    mesh = cpu_mesh()
    assert mesh.backend == 'gloo' and mesh.world_size == 2
    pts = np.arange(600 * 3, dtype=np.float32).reshape(600, 3)
    sig = np.ones((600, 3), np.float32)
    shards = [tsh.shard_points(mesh, r, pts, sig, sig) for r in (0, 1)]
    full = [torch.cat([s[k] for s in shards]).numpy() for k in range(4)]
    assert full[0].shape == (1024, 3)
    np.testing.assert_array_equal(full[0][:600], pts)
    np.testing.assert_array_equal(full[0][600:], np.repeat(pts[-1:], 424, 0))
    assert (full[2][600:] == 0).all() and not full[3][600:].any()
    assert full[3][:600].all()
    padded, n = tsh.pad_to_multiple(pts, 512)
    assert n == 600 and (padded[600:] == 0).all()
