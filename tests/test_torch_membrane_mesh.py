"""PyTorch port, the MembraneMesh fit held to the JAX package's on the
same cloud and seed mesh (tests/test_membrane_mesh.py:19-41 fixture).

On the CPU the port's kernel wrappers run their plain versions; the
same fit on a CUDA card runs K1, K2 and K3 (``chip_smoke.py``).
"""

import numpy as np
import torch

from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere

from ch_shrinkwrap_torch.models import MembraneMesh as TMesh

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

# the kinds of the JAX package's trace records; the port's trace holds
# these among its own spans (the seed, the set-up, the parts of a pass)
JAX_KINDS = ('cg_block', 'punch_holes', 'remove_necks', 'short_edges',
             'remesh')


def sphere_cloud(R=50.0, n=5000, sigma=3.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1)[:, None]
    pts = v * R + rng.normal(scale=sigma, size=(n, 3))
    return pts.astype(np.float32), np.full((n, 3), sigma, np.float32)


def check_sphere_fit(mesh):
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert abs(r.mean() - 50.0) < 1.5
    assert np.abs(r - 50.0).std() < 2.0
    assert mesh.euler_characteristic == 2
    assert mesh.is_manifold
    assert mesh._mean_edge_length < 8.0
    return r


def test_full_shrink_wrap_sphere_both_packages():
    """20 iterations with a remesh every 5 on the edge-length schedule:
    both packages meet the JAX suite's bounds and agree on the result."""
    pts, sigma = sphere_cloud()
    v, f = icosphere(3, radius=60.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=5,
              delaunay_remesh_frequency=0, neck_first_iter=-1)
    jm = JMesh(v, f, **kw)
    jm.shrink_wrap(pts, sigma, method='conjugate_gradient', max_iter=20,
                   minimum_edge_length=4.0)
    tm = TMesh(v, f, device='cpu', **kw)
    tm.shrink_wrap(pts, sigma, method='conjugate_gradient', max_iter=20,
                   minimum_edge_length=4.0)
    rj = check_sphere_fit(jm)
    rt = check_sphere_fit(tm)
    assert abs(rt.mean() - rj.mean()) < 0.1
    assert abs(rt.std() - rj.std()) < 0.1
    assert abs(tm.vertices.shape[0] - jm.vertices.shape[0]) \
        < 0.05 * jm.vertices.shape[0]
    # diagnostics
    assert tm.point_influence.shape[0] == tm.vertices.shape[0]
    assert tm.S0.shape == tm.vertices.shape
    assert tm.point_dis.min() >= 0
    assert [r.kind for r in tm.trace.records if r.kind in JAX_KINDS] == \
        [r.kind for r in jm.trace.records]
    assert tm._last_corr_method == 'brute'


def test_first_block_matches_jax_vertex_for_vertex():
    """One CG block before any remesh: both packages sort the same mesh
    the same way (bit-identical host code), so vertices pair up."""
    pts, sigma = sphere_cloud(n=3000, seed=1)
    v, f = icosphere(3, radius=60.0)
    kw = dict(kc=1.0, step_size=4.0, remesh_frequency=0,
              delaunay_remesh_frequency=0)
    jm = JMesh(v, f, **kw)
    jm.shrink_wrap(pts, sigma, max_iter=5)
    tm = TMesh(v, f, device='cpu', **kw)
    tm.shrink_wrap(pts, sigma, max_iter=5)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    assert np.abs(tm.vertices - jm.vertices).max() < 0.5
    np.testing.assert_allclose(tm.point_influence, jm.point_influence,
                               rtol=1e-3, atol=1e-3)
    for i in range(4):
        s_t, s_j = getattr(tm, f'S{i}'), getattr(jm, f'S{i}')
        assert s_t.shape == s_j.shape


def test_shrink_wrap_continues_with_cached_points():
    pts, sigma = sphere_cloud(n=1000)
    v, f = icosphere(2, radius=60.0)
    mesh = TMesh(v, f, kc=1.0, step_size=4.0, remesh_frequency=0,
                 delaunay_remesh_frequency=0, device='cpu')
    mesh.shrink_wrap(pts, sigma, max_iter=5)
    r1 = np.linalg.norm(mesh.vertices, axis=1).mean()
    mesh.shrink_wrap(max_iter=5)
    r2 = np.linalg.norm(mesh.vertices, axis=1).mean()
    assert r2 < r1


def test_windowed_fit_with_gather_tables():
    """The production path on the CPU: windowed correspondence (K1, K2
    plain versions) and every gather through K3's plain version, with
    remeshing — same bounds as the brute-force fit."""
    pts, sigma = sphere_cloud(n=12000, seed=4)
    v, f = icosphere(3, radius=60.0)
    tm = TMesh(v, f, kc=1.0, step_size=4.0, remesh_frequency=5,
               delaunay_remesh_frequency=0, device='cpu')
    tm.corr_method = 'windowed'
    tm.ring_gather_min_verts = 0
    tm.shrink_wrap(pts, sigma, max_iter=10, minimum_edge_length=4.0)
    r = np.linalg.norm(tm.vertices, axis=1)
    assert abs(r.mean() - 50.0) < 1.5
    assert tm.euler_characteristic == 2 and tm.is_manifold
    assert tm._last_corr_method == 'windowed'
    # the fit's points were Hilbert-sorted once for the windowed search
    assert tm._points.shape == pts.shape


def test_curvature_properties_on_sphere():
    v, f = icosphere(4, radius=20.0)
    tm = TMesh(v, f, device='cpu', smooth_curvature=False)
    jm = JMesh(v, f, smooth_curvature=False)
    H, K = tm.curvature_mean, tm.curvature_gaussian
    np.testing.assert_allclose(np.abs(H), 1 / 20.0, rtol=0.05)
    np.testing.assert_allclose(K, 1 / 400.0, rtol=0.1)
    np.testing.assert_allclose(H, jm.curvature_mean, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(tm.curvature_principal0,
                               jm.curvature_principal0, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(tm.E, jm.E, rtol=1e-3, atol=1e-8)
    assert tm.curvature_grad().shape == (v.shape[0], 3)
