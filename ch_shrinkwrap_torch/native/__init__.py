"""ctypes binding for the native host topology engine.

Compiles ``topology.cpp`` with g++ on first use when the shared library
is missing or was built from another source (no pip/pybind11
dependency).  The engine is required: without a working g++,
``get_lib`` raises with the compiler's error.  The numpy remesh passes
(``mesh.remesh.remesh(use_native=False)``) are a different algorithm
(batched independent sets, not sequential greedy passes) and give a
different mesh, so nothing falls back to them silently.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'topology.cpp')
_LIB = os.path.join(_HERE, 'libtopology.so')
_STAMP = _LIB + '.srchash'
# lines of g++'s stderr kept in the error of a failed build
_ERR_LINES = 20


def _src_hash():
    import hashlib
    with open(_SRC, 'rb') as fh:
        return hashlib.sha256(fh.read()).hexdigest()


_lib = None


def _build():
    """Compile ``_SRC`` into ``_LIB``; None on success, else the tail
    of each attempt's compiler error."""
    # compile under a private name and os.replace into place, so
    # processes building at the same time (test workers) never load a
    # half-written library
    tmp = '%s.tmp%d' % (_LIB, os.getpid())
    errors = []
    for flags in (['-O3', '-march=native'], ['-O3']):
        cmd = ['g++', *flags, '-shared', '-fPIC', '-o', tmp, _SRC]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            errors.append('%s: %s' % (' '.join(cmd), e))
            continue
        if r.returncode != 0:
            tail = r.stderr.strip().splitlines()[-_ERR_LINES:]
            errors.append('%s: exit %d\n%s' % (' '.join(cmd), r.returncode,
                                                '\n'.join(tail)))
            continue
        os.replace(tmp, _LIB)
        with open(tmp, 'w') as fh:
            fh.write(_src_hash())
        os.replace(tmp, _STAMP)
        return None
    return '\n'.join(errors)


def _lib_current():
    """True iff the .so on disk was built from the current source ON
    THIS machine (a copied/stale binary built elsewhere with
    -march=native could SIGILL at call time; mtime comparison cannot
    catch that after a fresh checkout)."""
    if not os.path.exists(_LIB):
        return False
    try:
        with open(_STAMP) as fh:
            return fh.read().strip() == _src_hash()
    except OSError:
        return False


def get_lib():
    """The loaded shared library, compiled first when missing or stale.

    Raises RuntimeError, with the library's path and the compiler's or
    the loader's error, when it cannot be built or loaded; a failure is
    not cached, so the next call tries again."""
    global _lib
    if _lib is not None:
        return _lib
    if not _lib_current():
        err = _build()
        if err is not None:
            raise RuntimeError('native host engine: g++ could not build '
                               '%s from %s:\n%s' % (_LIB, _SRC, err))
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as e:
        raise RuntimeError('native host engine: cannot load %s: %s'
                           % (_LIB, e)) from e

    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.remesh_native.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, f32p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_int64)]
    lib.remesh_native.restype = None
    lib.build_tables_native.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, ctypes.c_int]
    lib.build_tables_native.restype = None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.halfedge_twins_native.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, i32p, u8p, i32p]
    lib.halfedge_twins_native.restype = None
    lib.face_hygiene_native.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, u8p]
    lib.face_hygiene_native.restype = None
    lib.vertex_components_native.argtypes = [
        i32p, ctypes.c_int, ctypes.c_int, i32p]
    lib.vertex_components_native.restype = ctypes.c_int32
    lib.knn_field_native.argtypes = [
        f32p, ctypes.c_int64, f32p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, f32p]
    lib.knn_field_native.restype = None
    lib.knn_field_build_native.argtypes = [f32p, ctypes.c_int64]
    lib.knn_field_build_native.restype = ctypes.c_void_p
    lib.knn_field_query_native.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, f32p]
    lib.knn_field_query_native.restype = None
    lib.knn_field_free_native.argtypes = [ctypes.c_void_p]
    lib.knn_field_free_native.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.incidence_native.argtypes = [
        i32p, u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int,
        i32p, i32p, i32p, ctypes.c_int64, i64p]
    lib.incidence_native.restype = None
    lib.hilbert_codes_native.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.hilbert_codes_native.restype = None
    lib.face_hilbert_codes_native.argtypes = [
        f32p, i32p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64)]
    lib.face_hilbert_codes_native.restype = None
    lib.gaussian_k_native.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int, i32p, ctypes.c_int,
        f32p]
    lib.gaussian_k_native.restype = None
    lib.mean_edge_native.argtypes = [f32p, i32p, ctypes.c_int]
    lib.mean_edge_native.restype = ctypes.c_double
    lib.smooth_vertex_data_native.argtypes = [
        f32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        f32p]
    lib.smooth_vertex_data_native.restype = None
    lib.has_nonmanifold_vertices_native.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int64]
    lib.has_nonmanifold_vertices_native.restype = ctypes.c_int32
    lib.repair_native.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, u8p, ctypes.c_int,
        i64p, i64p]
    lib.repair_native.restype = ctypes.c_void_p
    lib.repair_fetch_native.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.repair_fetch_native.restype = None
    _lib = lib
    return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


# the engine's counts, in the order remesh_native writes them
REMESH_COUNTS = ('splits', 'collapses', 'flips', 'collapse_attempts',
                 'flip_attempts', 'collapse_early_rejects',
                 'flip_early_rejects', 'spills', 'compactions')


def remesh_capacity(vertices, faces, target):
    """Output capacities (vertices, faces) for a remesh of (V, F)
    toward ``target``, pre-sized from the edge-length ratio: a growth
    remesh multiplies the vertex count by ~(mean_edge/target)^2, and an
    undershoot costs a full second remesh run (overflow-retry)."""
    nv, nf = len(vertices), len(faces)
    growth = max(1.0, (mean_edge(vertices, faces) / max(target, 1e-6)) ** 2)
    return (int(nv * max(3.0, 2.0 * growth) + 1024),
            int(nf * max(3.0, 2.0 * growth) + 2048))


def remesh(vertices, faces, target, n_passes=5, l=0.5, n_relax=0,
           max_valence=20, veto_cos=None, veto_min_len=None):
    """Native isotropic remesh; returns (V, F, counts).

    ``counts`` maps each name of ``REMESH_COUNTS`` to the engine's
    count: splits, collapses and flips landed, collapse and flip
    attempts, the attempts its result and valence guards rejected
    before the edge and link walks, the incidence lists that outgrew
    their slab block, and the compactions between passes.

    ``veto_cos`` (opt-in): skip collapsing edges whose endpoint-normal
    dot falls below it while the edge is longer than ``veto_min_len``
    — the thin-tube pinch protection (remesh_collapse_veto)."""
    lib = get_lib()
    # with the collapse result-guard the passes equilibrate at the
    # nominal target itself (the pre-guard split/collapse churn used to
    # settle at ~1.45x, hence a historical 0.70 rescale — now removed)
    target = float(target)
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    nv, nf = len(v), len(f)
    v_cap, f_cap = remesh_capacity(v, f, target)
    counts = np.zeros(len(REMESH_COUNTS), np.int64)
    for _ in range(3):
        v_out = np.empty((v_cap, 3), np.float32)
        f_out = np.empty((f_cap, 3), np.int32)
        nv_out = np.zeros(1, np.int32)
        nf_out = np.zeros(1, np.int32)
        lib.remesh_native(_f32p(v), nv, _i32p(f), nf,
                          ctypes.c_float(target), n_passes,
                          ctypes.c_float(l), n_relax, max_valence,
                          _f32p(v_out), _i32p(f_out), _i32p(nv_out),
                          _i32p(nf_out), v_cap, f_cap,
                          ctypes.c_float(2.0 if veto_cos is None
                                         else float(veto_cos)),
                          ctypes.c_float(0.0 if veto_min_len is None
                                         else float(veto_min_len) ** 2),
                          counts.ctypes.data_as(
                              ctypes.POINTER(ctypes.c_int64)))
        if nv_out[0] >= 0:
            return (v_out[:nv_out[0]].copy(), f_out[:nf_out[0]].copy(),
                    dict(zip(REMESH_COUNTS, counts.tolist())))
        v_cap = int(-nv_out[0] * 1.3) + 1024
        f_cap = int(-nf_out[0] * 1.3) + 2048
    raise RuntimeError('native remesh: output overflowed its capacity '
                       '(%d vertices, %d faces) three times'
                       % (v_cap, f_cap))


# the repair's counts, in the order repair_native writes them
REPAIR_COUNTS = ('holes', 'passes', 'faces_added', 'split_vertices')


def repair(faces, n_vertices, remove=None, max_passes=8):
    """Native vertex removal and repair, bit-identical to the numpy
    passes of ``TriangleMesh._repair_numpy``; returns ``(faces, vmap,
    counts)``, with faces and vmap None when the mesh came out as it
    went in.

    ``remove``: bool (n_vertices,) mask of vertices to delete with
    every face touching them, or None.  ``vmap[i]`` is the input vertex
    that output vertex i is (a pinch point's copy maps to the vertex it
    was split from).  ``counts`` maps each name of ``REPAIR_COUNTS`` to
    its count: the boundary loops the fill passes walked, the passes
    that changed the mesh, the triangles they filled in, and the pinch
    points' copies.  Raises RuntimeError on a boundary walk that does
    not close, which the numpy passes would erode and the hygiene
    leaves none of."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    if f.ndim != 2 or f.shape[1] != 3 or (
            f.size and (f.min() < 0 or f.max() >= n_vertices)):
        raise ValueError('repair: faces %s must index %d vertices'
                         % (f.shape, n_vertices))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    if remove is None:
        rm_ptr = ctypes.cast(None, u8p)
    else:
        rm = np.ascontiguousarray(remove, dtype=np.uint8)
        if rm.shape != (n_vertices,):
            raise ValueError('repair: a removal mask of %s for %d vertices'
                             % (rm.shape, n_vertices))
        rm_ptr = rm.ctypes.data_as(u8p)
    sizes = np.zeros(3, np.int64)
    counts = np.zeros(len(REPAIR_COUNTS), np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    h = lib.repair_native(_i32p(f), len(f), int(n_vertices), rm_ptr,
                          int(max_passes), sizes.ctypes.data_as(i64p),
                          counts.ctypes.data_as(i64p))
    if not h:
        if sizes[2] == -1:
            raise RuntimeError('native repair: a boundary walk did not '
                               'close (%d faces)' % len(f))
        raise MemoryError('native repair: out of memory at %d faces'
                          % len(f))
    nv_out, nf_out, changed = (int(x) for x in sizes)
    faces_out = np.empty((nf_out, 3), np.int32)
    vmap = np.empty(nv_out, np.int32)
    lib.repair_fetch_native(h, _i32p(faces_out), _i32p(vmap))
    counts = dict(zip(REPAIR_COUNTS, counts.tolist()))
    return (faces_out, vmap, counts) if changed else (None, None, counts)


def mean_edge(vertices, faces):
    """Mean halfedge length (one native pass)."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    return float(lib.mean_edge_native(_f32p(v), _i32p(f), len(f)))


def build_tables(faces, n_vertices, K=20, out=None, want_face_adj=True):
    """Native neighbor tables; returns (nbr_v, nbr_f, face_nbrs).

    ``out=(nbr_v, nbr_f, face_nbrs)``: write rows [:n_vertices] /
    [:nf] directly into caller-held (row-capacity >= live count,
    C-contiguous i32) buffers — the fit loop passes its
    capacity-sized pad scratch so the tables never pay an extra
    (Vp, K) memcpy per remesh boundary.  ``want_face_adj=False``
    skips the twin-matching scan and returns face_nbrs=None."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    nf = len(f)
    if out is not None:
        nbr_v, nbr_f, face_nbrs = out
    else:
        nbr_v = np.empty((n_vertices, K), np.int32)
        nbr_f = np.empty((n_vertices, K), np.int32)
        face_nbrs = np.empty((nf, 3), np.int32) if want_face_adj else None
    # the native side never touches face_nbrs when the scan is skipped;
    # hand it a valid dummy pointer in that case
    fn_ptr = _i32p(face_nbrs) if face_nbrs is not None else _i32p(nbr_v)
    lib.build_tables_native(_i32p(f), nf, n_vertices, K,
                            _i32p(nbr_v), _i32p(nbr_f), fn_ptr,
                            1 if want_face_adj else 0)
    return nbr_v, nbr_f, (face_nbrs if want_face_adj else None)


def halfedge_twins(faces, n_vertices):
    """Native twin/dup/vertex_halfedge arrays for HalfedgeTables;
    returns (twin, dup, vertex_halfedge)."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    nf = len(f)
    twin = np.empty(3 * nf, np.int32)
    dup = np.empty(3 * nf, np.uint8)
    vhe = np.empty(n_vertices, np.int32)
    lib.halfedge_twins_native(
        _i32p(f), nf, n_vertices, _i32p(twin),
        dup.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _i32p(vhe))
    return twin, dup.astype(bool), vhe


def face_hygiene(faces, n_vertices):
    """Per-face bad flags (degenerate | duplicate triple | on an
    over-shared edge) for repair(); returns bool (F,), or None when
    n_vertices >= 2^21 (the packed key's range)."""
    if n_vertices >= (1 << 21):
        return None
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    bad = np.empty(len(f), np.uint8)
    lib.face_hygiene_native(
        _i32p(f), len(f), n_vertices,
        bad.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return bad.astype(bool)


def vertex_components(faces, n_vertices):
    """(labels, n_components) over the face-edge graph via native
    union-find (scipy labeling convention)."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    labels = np.empty(n_vertices, np.int32)
    n = lib.vertex_components_native(_i32p(f), len(f), n_vertices,
                                     _i32p(labels))
    return labels, int(n)


def knn_field(points, queries, k, bound):
    """Exact bounded k-th-NN distance field (the wrap_start density
    field): (Q,) float32 distances, with queries whose k-th neighbor
    lies beyond ``bound`` returned as 2*bound (caller clamps, matching
    scipy's distance_upper_bound -> inf convention)."""
    lib = get_lib()
    p = np.ascontiguousarray(points, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32)
    out = np.empty(len(q), np.float32)
    lib.knn_field_native(_f32p(p), ctypes.c_int64(len(p)),
                         _f32p(q), ctypes.c_int64(len(q)),
                         int(k), ctypes.c_float(float(bound)),
                         _f32p(out))
    return out


class KnnField:
    """Reusable bounded-kNN field over a fixed point set.

    The grid + chessboard-transform build is O(N) and depends only on
    the points; the punch pass queries the SAME localization cloud at
    every boundary, so holding one of these across calls amortizes the
    build (measured ~half the per-call cost at 1e6 points).
    ``KnnField.create`` returns None for an empty point set.
    """

    def __init__(self, handle, lib):
        self._h = handle
        self._lib = lib

    @staticmethod
    def create(points):
        lib = get_lib()
        p = np.ascontiguousarray(points, dtype=np.float32)
        h = lib.knn_field_build_native(_f32p(p), ctypes.c_int64(len(p)))
        if not h:
            return None
        return KnnField(h, lib)

    def query(self, queries, k, bound):
        q = np.ascontiguousarray(queries, dtype=np.float32)
        out = np.empty(len(q), np.float32)
        self._lib.knn_field_query_native(
            self._h, _f32p(q), ctypes.c_int64(len(q)),
            int(k), ctypes.c_float(float(bound)), _f32p(out))
        return out

    def __del__(self):
        h, self._h = self._h, None
        if h:
            try:
                self._lib.knn_field_free_native(h)
            except Exception:
                pass


def hilbert_codes(X, bits):
    """Hilbert codes for pre-quantized (n, 3) uint32 coordinates;
    bit-exact twin of the numpy Skilling loops in
    ``ops.ordering.hilbert_order``."""
    lib = get_lib()
    Xc = np.ascontiguousarray(X, dtype=np.uint32)
    out = np.empty(len(Xc), np.uint64)
    lib.hilbert_codes_native(
        Xc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(Xc)), int(bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def face_hilbert_codes(vertices, faces, bits=10):
    """Fused face-centroid Hilbert codes (centroid + bbox + quantize +
    code in one native pass) — the spatial_sort face-ordering key
    without the numpy ``v[f].mean(1)`` gather chain.  Bit-exact twin
    of ``hilbert_codes_for(v[f].mean(1))``."""
    lib = get_lib()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    out = np.empty(len(f), np.uint64)
    lib.face_hilbert_codes_native(
        _f32p(v), _i32p(f), ctypes.c_int64(len(f)), int(bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def incidence(faces, f_mask, n_vertices, K=8):
    """Native vertex->incident-corner-row table
    (ops.meshdata.incidence_table); returns (inc (V, K) i32 -1-padded,
    ov_rows, ov_verts), the incident rows in ascending row order."""
    lib = get_lib()
    f = np.ascontiguousarray(faces, dtype=np.int32)
    fm = np.ascontiguousarray(f_mask, dtype=np.uint8)
    # every corner row overflows at most once
    ov_cap = 3 * len(f)
    inc = np.full((n_vertices, K), -1, np.int32)
    ov_rows = np.empty(ov_cap, np.int32)
    ov_verts = np.empty(ov_cap, np.int32)
    n_ov = ctypes.c_int64(0)
    lib.incidence_native(
        _i32p(f), fm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(f)), ctypes.c_int32(int(n_vertices)), int(K),
        _i32p(inc), _i32p(ov_rows), _i32p(ov_verts),
        ctypes.c_int64(ov_cap), ctypes.byref(n_ov))
    return inc, ov_rows[:n_ov.value].copy(), ov_verts[:n_ov.value].copy()


def gaussian_k(vertices, faces, nbr_v=None):
    """Native per-vertex Gaussian curvature (the K-only subset of
    ops.curvature.curvature_grad, method='lsq'); returns (V,) f32.

    The fit loop uses this for the boundary neck diagnostic
    (remove_necks consumes only K — counterpart of the reference's
    curvature recompute at pyx:1212) so the CG block need not carry
    the folded device curvature program (~9 MB of TPU executable
    through the remote compile service's ~0.6 MB/s load path).
    ``nbr_v`` (V, K) -1-padded one-ring table; built natively when
    omitted.
    """
    lib = get_lib()
    v = np.ascontiguousarray(vertices, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    nv = len(v)
    if nbr_v is None:
        nbr_v = build_tables(f, nv)[0]
    nb = np.ascontiguousarray(nbr_v, dtype=np.int32)
    K_out = np.empty(nv, np.float32)
    lib.gaussian_k_native(_f32p(v), nv, _i32p(f), len(f),
                          _i32p(nb), nb.shape[1], _f32p(K_out))
    return K_out


def smooth_vertex_data(data, nbr_v, n_iter=1):
    """One-ring average of per-vertex scalar data (incl. self) —
    bit-exact native twin of TriangleMesh.smooth_per_vertex_data
    (float64 accumulation in neighbor-slot order).  Returns (V,) f32."""
    lib = get_lib()
    d = np.ascontiguousarray(data, dtype=np.float32)
    nb = np.ascontiguousarray(nbr_v, dtype=np.int32)
    if d.ndim != 1 or nb.ndim != 2 or nb.shape[0] != d.shape[0]:
        raise ValueError('smooth_vertex_data: data %s against a %s '
                         'neighbour table' % (d.shape, nb.shape))
    out = np.empty(d.shape[0], np.float32)
    lib.smooth_vertex_data_native(_f32p(d), _i32p(nb),
                                  ctypes.c_int64(d.shape[0]),
                                  int(nb.shape[1]), int(n_iter),
                                  _f32p(out))
    return out


def has_nonmanifold_vertices(he_src, he_vertex, he_twin, he_next, nv):
    """Fan-count nonmanifold-vertex test over packed halfedge tables
    (twin of mesh.core._has_nonmanifold_vertices's union-find, which
    costs ~2 s of pure-Python find() at 131k verts).  Returns bool."""
    lib = get_lib()
    s = np.ascontiguousarray(he_src, dtype=np.int32)
    v = np.ascontiguousarray(he_vertex, dtype=np.int32)
    t = np.ascontiguousarray(he_twin, dtype=np.int32)
    n = np.ascontiguousarray(he_next, dtype=np.int32)
    r = lib.has_nonmanifold_vertices_native(
        _i32p(s), _i32p(v), _i32p(t), _i32p(n),
        ctypes.c_int64(len(s)), ctypes.c_int64(int(nv)))
    return bool(r)
