"""PyTorch port, the repair: vertex removal and hole repair in one native
call against the numpy passes it replaces, bit for bit.

``TriangleMesh.repair`` hands the removal and every pass to the host
engine (``native.repair``); the numpy passes
(``torch_host_reference.ReferenceMesh.repair``, numpy and scipy only)
are the reference here.  On meshes from 80 to 20480 faces the vertices,
the faces, a carried per-vertex array and the counts must come out
equal.
"""

import numpy as np
import pytest

from ch_shrinkwrap_torch import native
from ch_shrinkwrap_torch.mesh.core import TriangleMesh
from ch_shrinkwrap_torch.mesh.primitives import icosphere

from torch_host_reference import ReferenceMesh


def sphere(sub=4, radius=50.0):
    v, f = icosphere(sub, radius=radius)
    return v.astype(np.float32), np.asarray(f, np.int32)


def ring_of(f, verts):
    """The vertices of every face that touches ``verts``."""
    return np.unique(f[np.isin(f, list(verts)).any(1)])


def scattered():
    """Thirty small clusters of a few vertices each, far apart."""
    v, f = sphere(5)
    rng = np.random.default_rng(0)
    rem = set()
    for c in rng.choice(len(v), 30, replace=False):
        rem.add(int(c))
        rem.update(int(r) for r in rng.choice(ring_of(f, [c]), 3))
    return v, f, np.array(sorted(rem))


def pinch():
    """A fifth of the vertices at random: the rings of neighbouring
    holes touch at vertices, which the split has to part."""
    v, f = sphere(4)
    rng = np.random.default_rng(1)
    return v, f, rng.choice(len(v), len(v) // 5, replace=False)


def tangled():
    """Flipped, repeated and glued faces (degenerate, duplicated, on
    over-shared edges), then a cut: the hygiene drops them first."""
    v, f = sphere(4)
    rng = np.random.default_rng(2)
    f = f.copy()
    idx = rng.choice(len(f), 6, replace=False)
    f[idx] = f[idx][:, ::-1]
    f = np.vstack([f, f[rng.choice(len(f), 4, replace=False)],
                   f[rng.choice(len(f), 2, replace=False)][:, ::-1]])
    glue = np.arange(len(v))
    for i in rng.choice(len(v), 12, replace=False):
        nb = ring_of(f, [i])
        glue[i] = nb[nb != i][0]
    f = glue[f].astype(np.int32)
    return v, f, rng.choice(len(v), 8, replace=False)


def debris():
    """The ring two edges out from a vertex: its star, six faces, comes
    loose as debris."""
    v, f = sphere(4)
    star = ring_of(f, [100])
    return v, f, np.setdiff1d(ring_of(f, star), star)


def freed_by_split():
    """A tetrahedron that shares one vertex with the sphere (a pinch
    point), and a hole elsewhere: the split parts the tetrahedron, four
    faces, and the debris check after it drops them."""
    v, f = sphere(4)
    a = 0
    tip = v[a] * 1.05
    n = len(v)
    extra = np.array([tip + [3.0, 0, 0], tip + [0, 3.0, 0],
                      tip + [0, 0, 3.0]], np.float32)
    tet = np.array([[a, n, n + 1], [a, n + 1, n + 2], [a, n + 2, n],
                    [n, n + 2, n + 1]], np.int32)
    far = int(np.argmin(v @ v[a]))
    return (np.vstack([v, extra]), np.vstack([f, tet]), np.array([far]))


def neck():
    """A band round the middle: two caps, each with its hole closed."""
    v, f = sphere(5)
    return v, f, np.flatnonzero(np.abs(v[:, 0]) < 3.0)


def small_scattered():
    """Scattered small holes in a sphere of 1280 faces."""
    v, f = sphere(3)
    rng = np.random.default_rng(3)
    return v, f, rng.choice(len(v), 12, replace=False)


def small_pinch():
    """A fifth of the vertices of a sphere of 1280 faces."""
    v, f = sphere(3)
    rng = np.random.default_rng(4)
    return v, f, rng.choice(len(v), len(v) // 5, replace=False)


def tiny():
    """A sphere of 80 faces cut into pieces, some of them debris."""
    v, f = sphere(1)
    rng = np.random.default_rng(5)
    return v, f, rng.choice(len(v), 8, replace=False)


def closed():
    v, f = sphere(4)
    return v, f, None


def raw():
    """A surface as a marching pass leaves it, repaired without a cut:
    unused vertices, a degenerate face and a repeated one."""
    v, f = sphere(4)
    v = np.vstack([v, np.zeros((3, 3), np.float32)])
    f = np.vstack([f, f[:1], [[f[5, 0], f[5, 0], f[5, 1]]]]).astype(np.int32)
    return v, f, None


CASES = {'scattered': scattered, 'pinch': pinch, 'tangled': tangled,
         'debris': debris, 'freed_by_split': freed_by_split, 'neck': neck,
         'closed': closed, 'raw': raw, 'small_scattered': small_scattered,
         'small_pinch': small_pinch, 'tiny': tiny,
         # the split and the debris check with no pass, or one, before
         'no_passes': freed_by_split, 'one_pass': tangled,
         # the reference with the native engine unloadable
         'no_engine': scattered}
MAX_PASSES = {'no_passes': 0, 'one_pass': 1}


def _no_engine():
    raise RuntimeError('the native engine is unloadable in this case')


def both_repairs(v, f, rem, max_passes=8, engine_off=False):
    """The native repair, then the reference; with ``engine_off`` the
    reference runs with ``native.get_lib`` raising, under which the
    native repair raises."""
    out = []
    for cls in (TriangleMesh, ReferenceMesh):
        m = cls(v.copy(), f.copy())
        m.extra_vertex_data = {'id': np.arange(len(v)),
                               'xy': v[:, :2].copy()}
        with pytest.MonkeyPatch.context() as mp:
            if engine_off and cls is ReferenceMesh:
                mp.setattr(native, 'get_lib', _no_engine)
                with pytest.raises(RuntimeError, match='unloadable'):
                    TriangleMesh(v.copy(), f.copy()).repair(
                        max_passes, remove=rem)
            counts = m.repair(max_passes, remove=rem)
        out.append((m, counts))
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_native_repair_equals_numpy_passes(case):
    v, f, rem = CASES[case]()
    (nm, nc), (pm, pc) = both_repairs(v, f, rem, MAX_PASSES.get(case, 8),
                                      engine_off=case == 'no_engine')
    np.testing.assert_array_equal(nm.vertices, pm.vertices)
    np.testing.assert_array_equal(nm.faces, pm.faces)
    assert nm.faces.dtype == pm.faces.dtype == np.int32
    for key in pm.extra_vertex_data:
        np.testing.assert_array_equal(nm.extra_vertex_data[key],
                                      pm.extra_vertex_data[key])
    # every vertex out carries its own (or, for a split copy, its
    # origin's) data
    np.testing.assert_array_equal(nm.vertices,
                                  v[nm.extra_vertex_data['id']])
    assert nc == pc
    assert list(nc) == list(native.REPAIR_COUNTS)
    if case == 'closed':
        assert set(nc.values()) == {0}
        np.testing.assert_array_equal(nm.faces, f)
    if case in ('scattered', 'neck', 'pinch', 'small_scattered',
                'small_pinch', 'no_engine'):
        assert nc['holes'] > 0 and nc['faces_added'] > 0
    if case in ('pinch', 'freed_by_split', 'small_pinch', 'no_passes'):
        assert nc['split_vertices'] > 0
    if case in ('freed_by_split', 'no_passes'):
        # the tetrahedron and the cut vertex go
        assert len(nm.vertices) == len(v) - 4
    if case == 'no_passes':
        assert nc['passes'] == nc['holes'] == 0
    if case == 'debris':
        assert nm.connected_components()[1] == 1
        assert len(nm.faces) < len(f) - 6
    if case == 'neck':
        assert nm.connected_components()[1] == 2
    if case in ('scattered', 'neck', 'debris', 'freed_by_split',
                'small_scattered', 'no_engine'):
        assert nm.is_manifold


@pytest.mark.parametrize('bad', ['mask_length', 'face_index', 'shape'])
def test_native_repair_checks_its_inputs(bad):
    """The engine indexes by the faces and the mask without checks of
    its own: the wrapper refuses what does not fit."""
    v, f = sphere(4)
    mask = np.zeros(len(v), bool)
    if bad == 'mask_length':
        mask = mask[:-1]
    elif bad == 'face_index':
        f = f.copy()
        f[7, 1] = len(v)
    else:
        f = f.ravel()
    with pytest.raises(ValueError):
        native.repair(f, len(v), mask)
