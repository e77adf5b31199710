"""PyTorch port, host layer: bit-identical to the JAX package, and the
port's import and device rules.

The host mesh code (spatial sort, neighbour tables, remesh, marching
seed, Hilbert codes) is numpy + the native engine in both packages; the
port keeps its own copy and runs its engine at every mesh size, where
the JAX package runs numpy below a size, so the same numpy inputs must
give the same bits.
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere as jico
from ch_shrinkwrap_tpu.mesh.remesh import remesh as jremesh
from ch_shrinkwrap_tpu.mesh.marching import wrap_start as jwrap
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu import native as jnative

from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TMesh
from ch_shrinkwrap_torch.mesh.primitives import icosphere as tico
from ch_shrinkwrap_torch.mesh.remesh import remesh as tremesh
from ch_shrinkwrap_torch.mesh.marching import wrap_start as twrap
from ch_shrinkwrap_torch.ops import meshdata as tmd
from ch_shrinkwrap_torch.ops import ordering as tord
from ch_shrinkwrap_torch import native as tnative

import torch_host_reference as host_reference
from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def noisy_sphere(sub, seed=0, radius=50.0, noise=0.3):
    v, f = jico(sub, radius=radius)
    tv, tf = tico(sub, radius=radius)
    np.testing.assert_array_equal(v, tv)
    np.testing.assert_array_equal(f, tf)
    rng = np.random.default_rng(seed)
    v = (v + rng.normal(scale=noise, size=v.shape)).astype(np.float32)
    return v, f


def sphere_points(n, radius=50.0, sigma=3.0, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    return (d * radius + rng.normal(scale=sigma, size=(n, 3))
            ).astype(np.float32)


@pytest.mark.parametrize('sub', [3, 5])
def test_spatial_sort_bit_identical(sub):
    v, f = noisy_sphere(sub, seed=sub)
    a, b = JMesh(v, f), TMesh(v, f)
    a.spatial_sort()
    b.spatial_sort()
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize('hilbert_faces', [True, False])
def test_from_mesh_tables_bit_identical(hilbert_faces):
    """Capacities, padding and neighbour tables row for row."""
    v, f = noisy_sphere(4, seed=1)
    ja = jmd.from_mesh(JMesh(v, f), quantum=256,
                       hilbert_faces=hilbert_faces)
    ta = tmd.from_mesh(TMesh(v, f), quantum=256,
                       hilbert_faces=hilbert_faces, device='cpu')
    for name in ('positions', 'v_mask', 'faces', 'f_mask', 'nbr_v',
                 'nbr_f', 'face_nbrs'):
        np.testing.assert_array_equal(np.asarray(getattr(ja, name)),
                                      getattr(ta, name).numpy(),
                                      err_msg=name)
    assert ta.positions.dtype == torch.float32
    assert ta.faces.dtype == torch.int32


def test_numpy_neighbor_tables_match_native():
    v, f = noisy_sphere(3, seed=2)
    ta = tmd.from_mesh(TMesh(v, f), quantum=256, hilbert_faces=False,
                       device='cpu')
    nv, nf = host_reference.neighbor_tables(f, v.shape[0])
    np.testing.assert_array_equal(ta.nbr_v.numpy()[:v.shape[0]], nv)
    np.testing.assert_array_equal(ta.nbr_f.numpy()[:v.shape[0]], nf)
    np.testing.assert_array_equal(ta.face_nbrs.numpy()[:f.shape[0]],
                                  host_reference.face_adjacency(f))


def _cut_sphere(sub):
    """A noisy sphere with a cap cut away: a boundary loop."""
    v, f = noisy_sphere(sub, seed=10 + sub)
    return v, f[v[f].mean(1)[:, 2] < 0.6 * v[:, 2].max()]


def _duplicated_edges():
    """A repeated face, a flipped copy of another and a degenerate face:
    directed edges that appear twice, and an edge on three faces."""
    v, f = noisy_sphere(2, seed=11)
    return v, np.vstack([f, f[3:4], f[7:8, ::-1],
                         [[f[9, 0], f[9, 0], f[9, 1]]]])


def _pinch():
    """Two spheres of 80 faces that share one vertex (two fans)."""
    v, f = noisy_sphere(1, seed=12)
    far = int(np.argmin(v @ v[0]))
    w = v + (v[0] - v[far])
    # the second sphere's vertex ``far`` is the first sphere's vertex 0
    ids = np.arange(len(v)) + len(v)
    ids[far] = 0
    return np.vstack([v, w]).astype(np.float32), np.vstack([f, ids[f]])


def _components():
    """Spheres of 80, 320 and 1280 faces, a tetrahedron and isolated
    vertices, with the vertices shuffled, so that the label order
    (scipy's: by each component's lowest vertex) is not the input's."""
    parts, faces, n = [], [], 0
    for sub, shift in ((1, 0.0), (2, 150.0), (3, -150.0)):
        v, f = noisy_sphere(sub, seed=13 + sub)
        parts.append(v + np.float32(shift))
        faces.append(f + n)
        n += len(v)
    parts.append(np.eye(4, 3, dtype=np.float32) * 5 + 300)
    faces.append(np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]]) + n)
    n += 4
    parts.append(np.full((6, 3), -300.0, np.float32))
    perm = np.random.default_rng(13).permutation(n + 6)
    inv = np.argsort(perm)
    v = np.vstack(parts)[perm]
    return v, inv[np.vstack(faces)]


def _soups():
    """Random face soups over a few vertices: degenerate and repeated
    faces, over-shared edges, pinches and unused vertices at once."""
    rng = np.random.default_rng(14)
    v = rng.normal(size=(9, 3)).astype(np.float32)
    return v, rng.integers(0, 9, size=(12, 3))


HOST_MESHES = {
    'no_vertices': lambda: (np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.int32)),
    'no_faces': lambda: (np.ones((5, 3), np.float32),
                         np.zeros((0, 3), np.int32)),
    'unused_vertices': lambda: (
        np.vstack([noisy_sphere(1, seed=15)[0],
                   np.zeros((3, 3), np.float32)]),
        noisy_sphere(1, seed=15)[1]),
    'boundary': lambda: _cut_sphere(2),
    'duplicated_edges': _duplicated_edges,
    'pinch': _pinch,
    'components': _components,
    'soups': _soups,
    # the old size tests: 4096 halfedges (the fan test), 4096 faces
    # (components), 8192 halfedges (twins), 4096 vertices (smoothing)
    'sphere_1280': lambda: noisy_sphere(3, seed=16),
    'sphere_5120': lambda: noisy_sphere(4, seed=17),
    'cut_sphere_5120': lambda: _cut_sphere(4),
    'sphere_20480': lambda: noisy_sphere(5, seed=18),
}


@pytest.mark.parametrize('case', list(HOST_MESHES))
def test_host_primitives_bit_identical(case):
    """The port's twins, components, fan test and one-ring smoothing (the
    native engine at every size) against the JAX package's (numpy below
    its size tests, its own engine above them), bit for bit."""
    v, f = HOST_MESHES[case]()
    f = np.ascontiguousarray(f, dtype=np.int32)
    cases = [(v, f)]
    if case == 'soups':
        rng = np.random.default_rng(19)
        cases += [(v, rng.integers(0, len(v), size=(int(n), 3)).astype(
            np.int32)) for n in rng.integers(1, 12, size=200)]
    for v, f in cases:
        a, b = JMesh(v, f), TMesh(v, f)
        for name in ('twin', 'nonmanifold_edges', 'vertex_halfedge'):
            x, y = getattr(a.halfedges, name), getattr(b.halfedges, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        (jl, jn), (tl, tn) = a.connected_components(), b.connected_components()
        assert jl.dtype == tl.dtype and jn == tn
        np.testing.assert_array_equal(jl, tl)
        assert a._has_nonmanifold_vertices() == b._has_nonmanifold_vertices()
        assert a.is_manifold == b.is_manifold
        # float32 data over eighty binades, so that the float64 sums round
        rng = np.random.default_rng(20)
        data = (rng.normal(size=len(v)) * 2.0 ** rng.integers(
            -60, 20, size=len(v))).astype(np.float32)
        for n_iter in (1, 2):
            x = a.smooth_per_vertex_data(data, n_iter=n_iter)
            y = b.smooth_per_vertex_data(data, n_iter=n_iter)
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x.view(np.int32),
                                          y.view(np.int32))
    if case == 'pinch':
        assert b._has_nonmanifold_vertices() and not b.is_manifold
    if case == 'components':
        assert b.connected_components()[1] == 3 + 1 + 6
    if case in ('boundary', 'cut_sphere_5120'):
        assert b.n_boundary_loops == 1


@pytest.mark.parametrize('bad', ['negative', 'past_the_end'])
def test_host_engine_refuses_faces_out_of_range(bad):
    """The engine indexes by the faces without checks of its own, at
    every size now: the twins and the components refuse faces that do
    not index the vertices, as the numpy forms did by raising."""
    v, f = noisy_sphere(1, seed=21)
    f = f.copy()
    if bad == 'negative':
        f[3, 2] = -1
    else:
        f[5, 0] = len(v)
    with pytest.raises(ValueError, match='must index'):
        TMesh(v, f).halfedges
    with pytest.raises(ValueError, match='must index'):
        TMesh(v, f).connected_components()


@pytest.mark.parametrize('target_scale,n_relax', [(0.6, 0), (1.3, 2)])
def test_remesh_bit_identical(target_scale, n_relax):
    v, f = noisy_sphere(4, seed=3)
    a, b = JMesh(v, f), TMesh(v, f)
    target = target_scale * a._mean_edge_length
    jremesh(a, n=3, target_edge_length=target, n_relax=n_relax)
    tremesh(b, n=3, target_edge_length=target, n_relax=n_relax)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


def _mean_edge(v, f):
    e = v[f[:, 0]] - v[f[:, 1]]
    return float(np.sqrt((e * e).sum(1)).mean())


def _engines_agree(v, f, target, **kw):
    """Both packages' native engines on (v, f): equal bits.  Returns
    the port's (V, F, counts)."""
    jv, jf = jnative.remesh(v, f, target, **kw)
    tv, tf, counts = tnative.remesh(v, f, target, **kw)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(jf, tf)
    return tv, tf, counts


def _growth_chain():
    """Three growth remeshes of a noisy subdivision-6 icosphere (0.8,
    0.7, 0.6 of its mean edge; 5 passes, no relax), in Hilbert order
    between them as in a fit; each compacts between passes."""
    v, f = noisy_sphere(6, seed=5)
    base = _mean_edge(v, f)
    for scale in (0.8, 0.7, 0.6):
        v, f, counts = _engines_agree(v, f, scale * base)
        assert counts['splits'] > counts['collapses'] > 0
        assert counts['compactions'] >= 1
        mesh = TMesh(v, f)
        mesh.spatial_sort()
        v, f = mesh.vertices, mesh.faces


def _collapse_veto():
    """The thin-tube collapse veto (the model's cosine and length) on a
    crumpled sphere, where it changes the mesh."""
    v, f = noisy_sphere(4, seed=6, noise=2.0)
    t = 0.7 * _mean_edge(v, f)
    vetoed, _, _ = _engines_agree(v, f, t, veto_cos=0.5,
                                  veto_min_len=0.25 * t)
    plain, _, _ = _engines_agree(v, f, t)
    assert vetoed.shape != plain.shape or (vetoed != plain).any()


def _coarsening_relaxed():
    """A coarsening remesh with relaxation between passes."""
    v, f = noisy_sphere(5, seed=7)
    _, _, counts = _engines_agree(v, f, 1.6 * _mean_edge(v, f), n_relax=3)
    assert counts['collapses'] > counts['splits']


def _spilled_lists():
    """Coarsening a crumpled sphere: collapses pile faces onto vertices
    beyond their slab block, so incidence lists move out and back."""
    v, f = noisy_sphere(4, seed=6, noise=3.0)
    _, _, counts = _engines_agree(v, f, 1.5 * _mean_edge(v, f))
    assert counts['spills'] > 0


@pytest.mark.parametrize('case', [_growth_chain, _collapse_veto,
                                  _coarsening_relaxed, _spilled_lists],
                         ids=lambda c: c.__name__.lstrip('_'))
def test_remesh_bit_identical_engines(case):
    """The port's engine against the JAX package's, call for call."""
    case()


def test_wrap_start_bit_identical():
    pts = sphere_points(20_000)
    a = jwrap(pts, offset=10.0, grid_n=24)
    b = twrap(pts, offset=10.0, grid_n=24)
    assert a.vertices.shape[0] > 100
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)


@pytest.mark.parametrize('n', [1000, 8192])
def test_hilbert_codes_and_orders_bit_identical(n):
    """The port's native codes at every size against the JAX package's
    (its numpy Skilling loops below 4096 points, its engine above)."""
    rng = np.random.default_rng(n)
    pts = np.vstack([sphere_points(n, seed=n),
                     rng.uniform(-150, 150, (n // 20, 3))]).astype(
        np.float32)
    np.testing.assert_array_equal(jcorr.hilbert_codes_for(pts),
                                  tord.hilbert_codes_for(pts))
    np.testing.assert_array_equal(jcorr.hilbert_order(pts),
                                  tord.hilbert_order(pts))
    np.testing.assert_array_equal(jcorr.morton_order(pts),
                                  tord.morton_order(pts))
    np.testing.assert_array_equal(jcorr.fit_point_order(pts),
                                  tord.fit_point_order(pts))


@pytest.mark.parametrize('n_total', [300, 20_480, 263_168])
def test_subsample_ids_bit_identical(n_total):
    np.testing.assert_array_equal(
        np.asarray(jcorr._subsample_ids(n_total, 1024)),
        tord._subsample_ids(n_total, 1024))


def test_incidence_table_bit_identical():
    v, f = noisy_sphere(4, seed=4)
    ja = jmd.from_mesh(JMesh(v, f), quantum=256)
    faces = np.asarray(ja.faces)
    fmask = np.asarray(ja.f_mask)
    Vp = ja.positions.shape[0]
    for K in (8, 5):
        for x, y in zip(jmd.incidence_table(faces, fmask, Vp, K=K),
                        tmd.incidence_table(faces, fmask, Vp, K=K)):
            np.testing.assert_array_equal(x, y)


_PORT_MODULES = [
    'ch_shrinkwrap_torch', 'ch_shrinkwrap_torch.convert',
    'ch_shrinkwrap_torch.mesh', 'ch_shrinkwrap_torch.mesh.marching',
    'ch_shrinkwrap_torch.mesh.remesh', 'ch_shrinkwrap_torch.native',
    'ch_shrinkwrap_torch.ops.ordering', 'ch_shrinkwrap_torch.ops._build',
    'ch_shrinkwrap_torch.ops.normals', 'ch_shrinkwrap_torch.ops.curvature',
    'ch_shrinkwrap_torch.ops.meshdata',
    'ch_shrinkwrap_torch.ops.correspondence',
    'ch_shrinkwrap_torch.ops.cuda_window',
    'ch_shrinkwrap_torch.ops.cuda_scatter',
    'ch_shrinkwrap_torch.ops.cuda_gather',
    'ch_shrinkwrap_torch.solver.shrinkwrap',
    'ch_shrinkwrap_torch.models', 'ch_shrinkwrap_torch.utils',
    'ch_shrinkwrap_torch.models.holepunch',
    'ch_shrinkwrap_torch.models.holepunch_sdf',
    'ch_shrinkwrap_torch.eval.delaunay_utils', 'ch_shrinkwrap_torch.sim',
    'ch_shrinkwrap_torch.sim.shape', 'ch_shrinkwrap_torch.sim.pointcloud',
    'ch_shrinkwrap_torch.solver.tikhonov',
    'ch_shrinkwrap_torch.models.skeleton_mesh',
    'ch_shrinkwrap_torch.eval', 'ch_shrinkwrap_torch.eval.metrics',
    'ch_shrinkwrap_torch.eval.screened_poisson',
    'ch_shrinkwrap_torch.eval.alpha_wrap',
    'ch_shrinkwrap_torch.eval.harness',
    'ch_shrinkwrap_torch.utils.checkpoint', 'ch_shrinkwrap_torch.recipes',
    'ch_shrinkwrap_torch.recipes.surface_fitting',
    'ch_shrinkwrap_torch.recipes.surface_feature_extraction',
    'ch_shrinkwrap_torch.parallel', 'ch_shrinkwrap_torch.parallel.sharding',
    'ch_shrinkwrap_torch.animation', 'ch_shrinkwrap_torch.visgui_modules',
    'ch_shrinkwrap_torch.visgui_modules.shrinkwrap',
    'ch_shrinkwrap_torch.visgui_modules.surface_feature_extraction',
    'ch_shrinkwrap_torch.recipes.simulation',
]


def test_port_imports_without_jax():
    """The port and chip_smoke's helpers import with jax unimportable,
    and importing them starts no build."""
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "p, s = chip_smoke.sphere_cloud(64)\n"
        "assert p.shape == (64, 3)\n"
        "assert chip_smoke.bound_ms(3.35e9, 0.0) == (1.0, 'bytes')\n"
        "from ch_shrinkwrap_torch.ops import _build\n"
        "assert _build._lib is None\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "or k.startswith('ch_shrinkwrap_tpu') for k in sys.modules "
        "if sys.modules[k] is not None)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, 'PYTHONPATH': REPO})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith('ok')


def test_no_jax_in_port_sources():
    pat = re.compile(r'import jax|from jax|ch_shrinkwrap_tpu')
    files = [os.path.join(REPO, 'chip_smoke.py')]
    files += [os.path.join(REPO, 'scripts', n)
              for n in os.listdir(os.path.join(REPO, 'scripts'))
              if n.startswith('torch_') and n.endswith('.py')]
    for root, _, names in os.walk(os.path.join(REPO,
                                               'ch_shrinkwrap_torch')):
        files += [os.path.join(root, n) for n in names
                  if n.endswith(('.py', '.cu', '.cpp', '.cuh', '.h'))]
    assert len(files) > 20
    hits = []
    for path in files:
        with open(path, encoding='utf-8') as fh:
            for i, line in enumerate(fh, 1):
                if pat.search(line):
                    hits.append(f'{path}:{i}: {line.strip()}')
    assert not hits, '\n'.join(hits)


def test_cuda_sources_are_plain_c():
    """Kernels build by nvcc into a ctypes library: no PyTorch header,
    no torch.utils.cpp_extension anywhere in the port."""
    csrc = os.path.join(REPO, 'ch_shrinkwrap_torch', 'csrc')
    from ch_shrinkwrap_torch.ops import _build
    assert sorted(os.listdir(csrc)) == sorted(_build.SOURCES)
    for name in _build.SOURCES:
        with open(os.path.join(csrc, name)) as fh:
            src = fh.read()
        includes = re.findall(r'#include\s*[<"]([^>"]+)', src)
        assert includes and not any(
            'torch' in i or 'ATen' in i or 'c10' in i or 'pybind' in i
            for i in includes), includes
        assert 'extern "C"' in src
    for root, _, names in os.walk(os.path.join(REPO,
                                               'ch_shrinkwrap_torch')):
        for n in names:
            if n.endswith('.py'):
                with open(os.path.join(root, n)) as fh:
                    assert not re.search(
                        r'^\s*(from|import)\s+\S*cpp_extension'
                        r'|cpp_extension\.load', fh.read(), re.M), n
    assert 'sm_90a' in ' '.join(_build.FLAGS)


def test_entry_points_default_to_cuda():
    from ch_shrinkwrap_torch.models import MembraneMesh
    from ch_shrinkwrap_torch.convert import state_from_numpy
    v, f = tico(2, radius=10.0)
    assert MembraneMesh(v, f).device == torch.device('cuda')
    assert MembraneMesh(v, f, device='cpu').device == torch.device('cpu')
    from ch_shrinkwrap_torch.convert import membrane_mesh_from
    from ch_shrinkwrap_torch.eval import harness
    from ch_shrinkwrap_torch.utils.checkpoint import load_fit_state
    from ch_shrinkwrap_torch.recipes import MODULE_REGISTRY
    for fn in (tmd.from_mesh, state_from_numpy, membrane_mesh_from,
               load_fit_state, harness.evaluate,
               harness.run_shrinkwrap_entry):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    for name in ('ShrinkwrapMembrane', 'ImageShrinkwrapMembrane'):
        assert MODULE_REGISTRY[name]().device == 'cuda'
    # a device mesh is CUDA cards unless CPU ranks are asked for: with
    # no card it raises instead of running on the CPU
    from ch_shrinkwrap_torch.parallel import sharding
    assert MembraneMesh(v, f).device_mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match='CUDA'):
            sharding.make_device_mesh(1)
        with pytest.raises(ValueError, match='CUDA'):
            sharding.mesh_for(1, 'cuda')


def test_kernel_wrappers_never_fall_back_off_cpu():
    """Only CPU tensors take the plain versions: a tensor on any other
    device goes to the kernel path, which refuses non-CUDA inputs
    instead of computing elsewhere."""
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_gather
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='CUDA'):
        cuda_gather.row_gather(torch.empty((10, 3), device=meta),
                               torch.zeros(5, dtype=torch.int32,
                                           device=meta))
    nb, B, Fp = 2, 256, 4096
    with pytest.raises(ValueError, match='CUDA'):
        cuda_window.window_min(
            torch.empty((nb, 3, B), device=meta),
            torch.zeros((nb, 3), dtype=torch.int32, device=meta),
            torch.empty((3, Fp), device=meta), torch.empty(Fp, device=meta),
            torch.zeros(1024, dtype=torch.int32, device=meta))
    N = nb * B
    with pytest.raises(ValueError, match='CUDA'):
        cuda_scatter.windowed_ah(
            torch.empty((N, 3), device=meta), torch.empty((N, 3),
                                                          device=meta),
            torch.zeros(N, dtype=torch.int32, device=meta),
            torch.zeros(N, dtype=torch.int32, device=meta),
            torch.zeros((nb, 3), dtype=torch.int32, device=meta),
            torch.zeros(1024, dtype=torch.int32, device=meta),
            num_segments=Fp)
    assert cuda_gather.row_gather.launches == 0
    assert cuda_window.window_min.launches == 0
    assert cuda_scatter.windowed_scatter.launches == 0


def test_not_ported_options_raise():
    """The options that once raised here (the shrink prior, the 'two'
    and 'bucketed' capacity modes) now run and follow the JAX package:
    the same capacities block for block and the same fitted radius.
    A 2-rank device_mesh fit runs (CPU ranks over gloo) and follows
    the one-process fit; more ranks than the machine allows raise."""
    from ch_shrinkwrap_tpu.models import MembraneMesh as JFit
    from ch_shrinkwrap_torch.models import MembraneMesh
    v, f = tico(2, radius=60.0)
    pts = sphere_points(500)
    for kw in ({'shrink_weight': 0.5}, {'capacity_mode': 'two'},
               {'capacity_mode': 'bucketed'}):
        kw = dict(kw, remesh_frequency=5, kc=1.0, step_size=4.0)
        m = MembraneMesh(v, f, device='cpu', **kw)
        m.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=6.0)
        jm = JFit(v, f, **kw)
        jm.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=6.0)
        caps = [[r.extra['v_cap'] for r in x.trace.records
                 if r.kind == 'cg_block'] for x in (m, jm)]
        assert caps[0] == caps[1], kw
        rt = np.linalg.norm(m.vertices, axis=1).mean()
        rj = np.linalg.norm(jm.vertices, axis=1).mean()
        assert abs(rt - rj) < 0.1, kw
    kw = dict(remesh_frequency=5, kc=1.0, step_size=4.0, device='cpu')
    m1 = MembraneMesh(v, f, **kw)
    m1.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=6.0)
    m = MembraneMesh(v, f, **kw)
    m.device_mesh = 2
    m.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=6.0)
    assert m.device_mesh.world_size == 2 and m.device_mesh.backend == 'gloo'
    r2 = np.linalg.norm(m.vertices, axis=1).mean()
    r1 = np.linalg.norm(m1.vertices, axis=1).mean()
    assert abs(r2 - r1) < 1.0
    assert m.euler_characteristic == 2 and m.is_manifold
    m = MembraneMesh(v, f, remesh_frequency=5, device='cpu')
    m.device_mesh = (os.cpu_count() or 1) + 1
    with pytest.raises(ValueError):
        m.shrink_wrap(pts, 3.0, max_iter=10)
    m = MembraneMesh(v, f, remesh_frequency=5)    # on 'cuda'
    m.device_mesh = torch.cuda.device_count() + 1
    with pytest.raises(ValueError):
        m.shrink_wrap(pts, 3.0, max_iter=10)


def test_convert_carries_corr_method_and_device_mesh():
    """A JAX model's correspondence method ('windowed_pallas' is the
    port's 'windowed') and its device mesh (as a device count) carry
    over, and the port's block and fit take the JAX name."""
    import jax
    from ch_shrinkwrap_tpu.models import MembraneMesh as JFit
    from ch_shrinkwrap_tpu.parallel.sharding import make_device_mesh
    from ch_shrinkwrap_torch.convert import membrane_mesh_from
    from ch_shrinkwrap_torch.models import MembraneMesh
    v, f = tico(2, radius=60.0)
    jm = JFit(v, f)
    assert membrane_mesh_from(jm, device='cpu').corr_method == 'auto'
    assert membrane_mesh_from(jm, device='cpu').device_mesh is None
    for method, want in (('windowed_pallas', 'windowed'), ('grid', 'grid'),
                         ('blocked', 'blocked'), ('brute', 'brute')):
        jm.corr_method = method
        assert membrane_mesh_from(jm, device='cpu').corr_method == want
    jm.device_mesh = 2
    assert membrane_mesh_from(jm, device='cpu').device_mesh == 2
    if len(jax.devices()) >= 2:
        jm.device_mesh = make_device_mesh(2)
        assert membrane_mesh_from(jm, device='cpu').device_mesh == 2
    pts = sphere_points(500)
    fits = []
    for method in ('windowed', 'windowed_pallas'):
        m = MembraneMesh(v, f, remesh_frequency=5, kc=1.0, step_size=4.0,
                         device='cpu')
        m.corr_method = method
        m.shrink_wrap(pts, 3.0, max_iter=5)
        assert m._last_corr_method == 'windowed'
        fits.append(m.vertices)
    np.testing.assert_array_equal(fits[0], fits[1])


def test_setup_packages_the_port():
    """setup.py names the port's packages, and its package data matches
    every CUDA source and the topology engine; the JAX package's
    entries stay."""
    import fnmatch
    import runpy
    import setuptools
    seen = {}

    def fake_setup(**kw):
        seen.update(kw)

    orig = setuptools.setup
    setuptools.setup = fake_setup
    cwd = os.getcwd()
    try:
        os.chdir(REPO)
        runpy.run_path(os.path.join(REPO, 'setup.py'))
    finally:
        setuptools.setup = orig
        os.chdir(cwd)
    pkgs = set(seen['packages'])
    for root, _, names in os.walk(os.path.join(REPO, 'ch_shrinkwrap_torch')):
        if '__init__.py' in names:
            rel = os.path.relpath(root, REPO).replace(os.sep, '.')
            assert rel in pkgs, rel
    assert {'ch_shrinkwrap_tpu', 'ch_shrinkwrap_tpu.native'} <= pkgs
    data = seen['package_data']
    assert data['ch_shrinkwrap_tpu.native'] == ['topology.cpp']
    csrc = os.path.join(REPO, 'ch_shrinkwrap_torch', 'csrc')
    cu = [n for n in os.listdir(csrc) if n.endswith('.cu')]
    assert len(cu) >= 3
    for n in cu:
        assert any(fnmatch.fnmatch(f'csrc/{n}', pat)
                   for pat in data['ch_shrinkwrap_torch']), n
    assert 'topology.cpp' in data['ch_shrinkwrap_torch.native']
