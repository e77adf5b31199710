"""PyTorch port, topology surgery: neck removal, hole punching, the SDF
punch, the Delaunay remesh and the fit schedule that runs them, held to
the JAX package on the same numpy inputs.

The surgery is host numpy plus the same native engine in both packages,
so on the same mesh and cloud the port must give the same vertices and
faces bit for bit.  The fit itself differs in float rounding (the CG
blocks), so the schedule test compares the schedule exactly and the
fitted surface within the bounds of
``test_full_shrink_wrap_sphere_both_packages``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.models.holepunch_sdf import \
    punch_holes_sdf as j_punch_sdf
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.mesh.marching import surface_from_function

from ch_shrinkwrap_torch.models import MembraneMesh as TMesh
from ch_shrinkwrap_torch.models.holepunch_sdf import \
    punch_holes_sdf as t_punch_sdf

import chip_smoke
from chip_smoke import torus_cloud

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def both(v, f, **kw):
    """The same mesh in each package (the port's on the CPU)."""
    return (JMesh(v.copy(), f.copy(), **kw),
            TMesh(v.copy(), f.copy(), device='cpu', **kw))


def assert_same_mesh(jm, tm):
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)


def sphere_cloud(R=50.0, n=5000, sigma=3.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = d * R + rng.normal(scale=sigma, size=(n, 3))
    return pts.astype(np.float32), np.full((n, 3), sigma, np.float32)


# ---------------------------------------------------------------------
# fixtures, each built once by the JAX package


@pytest.fixture(scope='module')
def dumbbell():
    """Two spheres bridged by a thin neck, marched and remeshed
    (tests/test_membrane_mesh.py:56-73)."""
    def f(p):
        d1 = np.linalg.norm(p - np.array([-22.0, 0, 0]), axis=1) - 20.0
        d2 = np.linalg.norm(p - np.array([22.0, 0, 0]), axis=1) - 20.0
        x = np.clip(p[:, 0], -22, 22)
        dc = np.sqrt((p[:, 0] - x) ** 2 + p[:, 1] ** 2
                     + p[:, 2] ** 2) - 5.0
        return np.minimum(np.minimum(d1, d2), dc)

    v, fc = surface_from_function(f, (-48, -26, -26, 48, 26, 26), 1.3)
    mesh = JMesh(v, fc, smooth_curvature=True)
    mesh.remesh(3, 2.2, 0.5, n_relax=5)
    return mesh.vertices.copy(), mesh.faces.copy()


@pytest.fixture(scope='module')
def noisy_sphere():
    """A wrinkled icosphere (tests/test_membrane_mesh.py:321-342)."""
    rng = np.random.default_rng(7)
    v, f = icosphere(4, radius=50.0)
    v = (v + rng.normal(scale=0.6, size=v.shape)).astype(np.float32)
    return v, f


@pytest.fixture(scope='module')
def tunnel():
    """An oblate spheroid pulled onto a torus cloud for 20 iterations
    (tests/test_holepunch.py:26-40): its two central sheets face each
    other with no points between them."""
    pts = torus_cloud()
    v, f = icosphere(3, radius=1.0)
    v = v * np.array([55.0, 14.0, 55.0], np.float32)
    mesh = JMesh(v, f, remesh_frequency=0, delaunay_remesh_frequency=0,
                 step_size=4.0, kc=1.0)
    mesh.shrink_wrap(pts, 3.0, max_iter=20)
    return mesh.vertices.copy(), mesh.faces.copy(), pts


@pytest.fixture(scope='module')
def hole_grid():
    """A flat spheroid fitted over a double sheet with four carved hole
    pairs (tests/test_holepunch.py:71-103)."""
    rng = np.random.default_rng(5)
    d = rng.normal(size=(60000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    surf = d * np.array([60.0, 10.0, 60.0])
    keep = np.ones(len(surf), bool)
    for cx, cz in [(-30.0, 0.0), (30.0, 0.0), (0.0, -30.0), (0.0, 30.0)]:
        keep &= ((surf[:, 0] - cx) ** 2 + (surf[:, 2] - cz) ** 2) > 16.0 ** 2
    pts = surf[keep].astype(np.float32)
    v, f = icosphere(3, radius=1.0)
    v = v * np.array([70.0, 16.0, 70.0], np.float32)
    mesh = JMesh(v, f, step_size=4.0, kc=1.0, remesh_frequency=5,
                 delaunay_remesh_frequency=0, neck_first_iter=-1)
    mesh.shrink_wrap(pts, 3.0, max_iter=15, minimum_edge_length=6.0)
    return mesh.vertices.copy(), mesh.faces.copy(), pts


# ---------------------------------------------------------------------
# neck removal


@pytest.mark.parametrize('detector', ['threshold', 'separator'])
def test_remove_necks_bit_identical(dumbbell, detector):
    """Both detectors sever the dumbbell's neck into the same two
    spheres as the JAX package, vertex for vertex."""
    v, f = dumbbell
    jm, tm = both(v, f, smooth_curvature=True)
    for m in (jm, tm):
        m.neck_detector = detector
        m.neck_separator_threshold = -1e-3
        assert m.connected_components()[1] == 1
    np.testing.assert_array_equal(tm.curvature_gaussian,
                                  jm.curvature_gaussian)
    jm.remove_necks(neck_curvature_threshold_low=-1e-3,
                    neck_curvature_threshold_high=1e-1)
    flagged, removed = tm.remove_necks(neck_curvature_threshold_low=-1e-3,
                                       neck_curvature_threshold_high=1e-1)
    assert 0 < removed <= flagged
    assert_same_mesh(jm, tm)
    labels, n = tm.connected_components()
    assert (np.bincount(labels, minlength=n) > 100).sum() == 2
    assert (tm.halfedges.twin >= 0).all()


def test_separator_spares_noisy_sphere(noisy_sphere):
    """Noise saddles that the threshold would flag disconnect nothing:
    the separator removes no vertex in either package."""
    v, f = noisy_sphere
    jm, tm = both(v, f, smooth_curvature=True)
    t_cand = -1e-4
    assert (tm.curvature_gaussian < t_cand).sum() > 20
    for m in (jm, tm):
        m.neck_detector = 'separator'
        m.neck_separator_threshold = t_cand
    jm.remove_necks(neck_curvature_threshold_low=t_cand,
                    neck_curvature_threshold_high=1e6)
    assert tm.remove_necks(neck_curvature_threshold_low=t_cand,
                           neck_curvature_threshold_high=1e6) == (0, 0)
    assert_same_mesh(jm, tm)
    np.testing.assert_array_equal(tm.vertices, v)
    assert tm.connected_components()[1] == 1


def test_threshold_safety_valve(noisy_sphere):
    """More than a quarter of the vertices over the thresholds is
    wrinkle noise: both packages leave the mesh as it is, and the port
    reports the flags with none removed."""
    v, f = noisy_sphere
    jm, tm = both(v, f, smooth_curvature=True)
    K = tm.curvature_gaussian
    lo = float(np.quantile(K, 0.4))
    n_flag = int((K < lo).sum())
    assert n_flag > 0.25 * len(v)
    jm.remove_necks(lo, 1e6)
    assert tm.remove_necks(lo, 1e6) == (n_flag, 0)
    assert_same_mesh(jm, tm)
    np.testing.assert_array_equal(tm.vertices, v)


# ---------------------------------------------------------------------
# hole punching


@pytest.mark.parametrize('case', ['tunnel', 'hole_grid', 'noop'])
def test_punch_holes_bit_identical(request, case):
    """The same punch count and the same mesh as the JAX package on the
    tunnel, the hole grid and a supported sphere
    (tests/test_holepunch.py:26,71,106)."""
    if case == 'noop':
        rng = np.random.default_rng(1)
        d = rng.normal(size=(5000, 3))
        d /= np.linalg.norm(d, axis=1)[:, None]
        pts = (d * 50).astype(np.float32)
        v, f = icosphere(3, radius=50.0)
        eps, want = 10.0, (0, 0)
    else:
        v, f, pts = request.getfixturevalue(case)
        eps, want = {'tunnel': (15.0, (1, 16)),
                     'hole_grid': (8.0, (3, 16))}[case]
    jm, tm = both(v, f)
    n_j = jm.punch_holes(pts, eps=eps)
    n_t = tm.punch_holes(pts, eps=eps)
    assert n_t == n_j
    assert want[0] <= n_t <= want[1]
    assert_same_mesh(jm, tm)
    assert tm.euler_characteristic == 2 - 2 * n_t
    assert tm.is_manifold
    # the kNN field is cached on the caller's points array
    field = tm._holepunch_field_cache[1]
    tm.punch_holes(pts, eps=eps)
    assert tm._holepunch_field_cache[1] is field


def test_punch_holes_sdf_matches_jax(tunnel):
    """The SDF punch carves the same surface in both packages, on the
    mesh's own device."""
    v, f, pts = tunnel
    jm, tm = both(v, f)
    for m in (jm, tm):
        m._points = pts
        m._sigma = 3.0
    mask_j = jm.point_influence[jm.faces].max(1) > 0.05
    mask_t = tm.point_influence[tm.faces].max(1) > 0.05
    np.testing.assert_array_equal(mask_t, mask_j)
    oj = j_punch_sdf(jm, offset=12.0, pi_threshold=0.05, grid_n=48)
    ot = t_punch_sdf(tm, offset=12.0, pi_threshold=0.05, grid_n=48)
    assert isinstance(ot, TMesh) and ot.device == torch.device('cpu')
    assert_same_mesh(oj, ot)
    assert ot.euler_characteristic < 2


def test_delaunay_remesh_bit_identical():
    """The surface rebuilt from the Delaunay hull of a noisy sphere's
    vertices is the JAX package's."""
    v, f = icosphere(2, radius=30.0)
    rng = np.random.default_rng(3)
    v = (v + rng.normal(scale=0.5, size=v.shape)).astype(np.float32)
    jm, tm = both(v, f)
    jm.delaunay_remesh(None)
    tm.delaunay_remesh(None)
    assert_same_mesh(jm, tm)
    assert tm.faces.shape[0] > 100
    assert tm.euler_characteristic == 2 and tm.is_manifold


# ---------------------------------------------------------------------
# the fit schedule: remesh every 5, punch every 13, necks after 9


def _schedule_fit(M, pts, sigma, max_iter, **extra):
    v, f = icosphere(3, radius=60.0)
    m = M(v, f, kc=1.0, step_size=4.0, remesh_frequency=5,
          delaunay_remesh_frequency=13, delaunay_eps=15.0,
          neck_first_iter=9, neck_threshold_low=-1e-3,
          neck_threshold_high=1e-2, **extra)
    if M is JMesh:
        m.speculative_blocks = False
    m.shrink_wrap(pts, sigma, method='conjugate_gradient',
                  max_iter=max_iter, minimum_edge_length=8.0)
    return m


@pytest.mark.parametrize('max_iter', [30, 29])
def test_fit_schedule_matches_jax(max_iter):
    """Both cadences on: the same (kind, iteration) trace as the JAX
    package, the same remesh targets (the edge-length step divides by
    gcd(5, 13) * max_iter, so 29 iterations also catch a step taken
    from the remesh cadence alone), and the same surface within the
    sphere fit's bounds."""
    pts, sigma = sphere_cloud(n=1000)
    jm = _schedule_fit(JMesh, pts, sigma, max_iter)
    tm = _schedule_fit(TMesh, pts, sigma, max_iter, device='cpu')
    trace_j = [(r.kind, r.iteration) for r in jm.trace.records]
    trace_t = [(r.kind, r.iteration) for r in tm.trace.records]
    assert trace_t == trace_j
    assert ('punch_holes', 26) in trace_t
    assert ('remove_necks', 10) in trace_t
    assert ('remove_necks', 5) not in trace_t
    tgt_j = [r.extra['target_length'] for r in jm.trace.records
             if r.kind == 'remesh']
    tgt_t = [r.extra['target_length'] for r in tm.trace.records
             if r.kind == 'remesh']
    np.testing.assert_allclose(tgt_t, tgt_j, rtol=0, atol=1e-6)
    for rec in tm.trace.records:
        if rec.kind == 'remove_necks':
            assert 0 <= rec.extra['necks_removed'] \
                <= rec.extra['necks_flagged']
        if rec.kind == 'cg_block':
            assert rec.extra['block_s'] <= rec.wall_time
    rj = np.linalg.norm(jm.vertices, axis=1)
    rt = np.linalg.norm(tm.vertices, axis=1)
    assert abs(rt.mean() - rj.mean()) < 0.1
    assert abs(rt.std() - rj.std()) < 0.1
    assert abs(tm.vertices.shape[0] - jm.vertices.shape[0]) \
        < 0.05 * jm.vertices.shape[0]
    assert tm.euler_characteristic == 2 and tm.is_manifold


def test_e2e_script_on_cpu():
    """scripts/torch_e2e_fit.py at a tiny size ends in one JSON line
    with the fit's readings and the trace's wall totals."""
    cmd = [sys.executable, os.path.join(REPO, 'scripts',
                                        'torch_e2e_fit.py'),
           '--device', 'cpu', '--n-points', '1000', '--radius', '50',
           '--iters', '12', '--punch-frequency', '6',
           '--neck-first-iter', '5', '--minimum-edge-length', '8',
           '--grid-n', '12']
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=240, env={**os.environ, 'OMP_NUM_THREADS':
                                         '1', 'PYTHONPATH': REPO})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith('wrap_start:')
    assert any(ln.startswith('fit: ') for ln in lines)
    out = json.loads(lines[-1])
    for key in ('seed_s', 'fit_s', 'V', 'R_mean', 'R_std', 'euler',
                'manifold', 'components', 'n_punched', 'wall', 'card'):
        assert key in out, key
    assert out['card'] is None and out['device'] == 'cpu'
    assert out['V'] > 100 and np.isfinite(out['R_mean'])
    for kind in ('cg_block', 'remesh', 'short_edges', 'remove_necks',
                 'punch_holes', 'sort', 'pad', 'tables', 'block'):
        assert out['wall'][kind] >= 0.0, kind
    kinds = [ln.split()[:2] for ln in lines
             if ln.split()[0] in ('punch_holes', 'remove_necks')]
    assert ['punch_holes', '6'] in kinds and ['remove_necks', '10'] in kinds
    assert ['remove_necks', '5'] not in kinds


def test_chip_smoke_fit99_phase_on_cpu():
    """chip_smoke.py's north-star phase at a tiny size on the CPU: the
    schedule's surgery shows in its trace, and its wall by phase splits
    the CG blocks' host rebuild from the blocks."""
    fit = chip_smoke.phase_fit99('cpu', n_points=1000, radius=50.0,
                                 grid_n=12, iters=12, punch_frequency=6,
                                 neck_first_iter=5, min_edge=8.0)
    assert fit['method'] == 'brute'
    assert fit['euler'] == 2 and fit['manifold']
    kinds = [(rec[0], rec[1]) for rec in fit['trace']]
    assert kinds.index(('punch_holes', 6)) < kinds.index(('cg_block', 10))
    assert kinds.index(('remove_necks', 10)) \
        < kinds.index(('short_edges', 10)) < kinds.index(('remesh', 10))
    wall = fit['wall']
    assert wall['block'] <= wall['cg_block']
    assert 0.0 < fit['host_share'] < 1.0
    assert abs(fit['host_s'] - (fit['fit_s'] - wall['block'])) < 1e-9
    for key in ('sort', 'pad', 'tables', 'remesh', 'short_edges',
                'remove_necks', 'punch_holes'):
        assert wall[key] >= 0.0, key


def test_repair_splits_pinch_points_the_jax_package_leaves():
    """Two spheres share one vertex (a pinch point) and one sphere has a
    hole.  The JAX package's repair closes the hole and returns before
    its pinch split, leaving a non-manifold surface; the port's repair
    always splits pinch points: two closed manifold spheres.  On every
    other fixture of this file the two repairs agree bit for bit."""
    from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JTri
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TTri
    v, f = icosphere(1, radius=10.0)
    n = len(v)
    i = int(np.argmax(v[:, 0]))
    # the second sphere: the first reflected through its vertex i, which
    # both share; the reflection reverses the winding
    ids = np.arange(n) + n
    ids[i] = i
    ids[i + 1:] -= 1
    verts = np.vstack([v, np.delete(2 * v[i] - v, i, 0)]).astype(np.float32)
    faces = np.vstack([f, ids[f][:, ::-1]]).astype(np.int32)
    hole = np.array([int(np.argmin(v[:, 0]))])
    out = {}
    for name, cls in (('jax', JTri), ('port', TTri)):
        m = cls(verts.copy(), faces.copy())
        assert not m.is_manifold           # the pinch
        m.unsafe_remove_vertices(hole)
        m.repair()
        out[name] = (bool(m.is_manifold), int(m.euler_characteristic),
                     int(m.connected_components()[1]))
    assert out['jax'] == (False, 3, 1)
    assert out['port'] == (True, 4, 2)


def test_neck_pass_drops_the_fragments_it_cuts_off():
    """Flagging the ring around an edge's two fans cuts off those fans:
    a closed 16-face piece outside the surface (lifted off it, so not
    nested), which the JAX package keeps (two components) and the port
    drops as debris (one sphere)."""
    from ch_shrinkwrap_tpu.mesh.primitives import icosphere as jico
    v, f = jico(3, radius=50.0)

    def ring_of(S):
        return set(np.unique(f[np.isin(f, list(S)).any(1)]).tolist())
    a = 100
    b = min(ring_of({a}) - {a})
    piece = ring_of({a, b})
    K = np.zeros(len(v))
    K[sorted(ring_of(piece) - piece)] = 1.0   # above the high threshold
    v = v.copy()
    v[sorted(piece)] *= 1.2
    out = {}
    for name, cls, kw in (('jax', JMesh, {}), ('port', TMesh,
                                                {'device': 'cpu'})):
        m = cls(v.copy(), f.copy(), **kw)
        m._curv_state = {'K': K.copy()}
        m.remove_necks(-1e-3, 1e-2, defer_remesh=True)
        _, n_comp = m.connected_components()
        out[name] = (int(n_comp), int(m.euler_characteristic),
                     bool(m.is_manifold))
    assert out['jax'] == (2, 4, True)
    assert out['port'] == (1, 2, True)
