"""Padded mesh arrays on a torch device.

The host mesh (``mesh.core.TriangleMesh``) is compact; the solver works
on fixed-capacity padded tensors with validity masks.  Capacities and
padding are those of the JAX package's ``ops/meshdata.py`` so the two
packages' arrays compare row for row.  The JAX package's TPU compile
and VMEM machinery (``fetch_ladder``, ``_prefix_mask``, ``lazy_tables``,
``fold_schedule``, ``fit_ring_schedules``) has no counterpart here: the
port's row-gather kernel (K3) reads plain index streams, which
:func:`gather_tables` builds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEIGHBORSIZE = 20
# face-side subspace normal equations (cg_block face_hcgc) engage above
# this padded vertex count, as in the JAX package
HCGC_MIN_VP = 300_000
# neighbour slots carried by the curvature prior's k-major gather stream
# (remeshed fit meshes have valence <= 7; larger valences ride the
# overflow lists), and incident corners per vertex in the fold's table
NCC_K = 8
FOLD_K = 8


def round_up_bucket(n: int, quantum: int = 1024) -> int:
    """Round n up to the next capacity bucket (quantum multiple)."""
    return max(quantum, int(np.ceil(n / quantum)) * quantum)


def pow2_bucket(n: int, quantum: int = 1024) -> int:
    """Round n up to the next power-of-two multiple of ``quantum``."""
    b = quantum
    while b < n:
        b *= 2
    return b


def fit_buckets(n_vertices: int, n_faces: int, quantum: int = 1024):
    """The (v_cap, f_cap) a bucketed fit pads a mesh of this size to:
    15% headroom, +8 vertex slack, power-of-two buckets."""
    return (pow2_bucket(int(1.15 * n_vertices) + 8, quantum),
            pow2_bucket(int(1.15 * n_faces), quantum))


class MeshArrays(NamedTuple):
    """Fixed-capacity tensor view of a triangle mesh.

    positions : (Vp, 3) f32 — padded vertex positions (pad rows 0)
    v_mask    : (Vp,)  bool — True for real vertices
    faces     : (Fp, 3) i32 — padded faces (padding rows point at 0)
    f_mask    : (Fp,)  bool
    nbr_v     : (Vp, K) i32 — one-ring neighbour vertex ids, -1 padded
    nbr_f     : (Vp, K) i32 — face left of the halfedge v->nbr, -1 padded
    face_nbrs : (Fp, 3) i32 — edge-adjacent faces, -1 on boundary
    host      : numpy copies of {faces, f_mask, nbr_v, nbr_f, face_nbrs}
                plus the live counts V, F, read by the host-side table code
    """
    positions: torch.Tensor
    v_mask: torch.Tensor
    faces: torch.Tensor
    f_mask: torch.Tensor
    nbr_v: torch.Tensor
    nbr_f: torch.Tensor
    face_nbrs: torch.Tensor
    host: Optional[dict] = None

    @property
    def n_vertices_padded(self):
        return self.positions.shape[0]

    @property
    def n_faces_padded(self):
        return self.faces.shape[0]


def from_mesh(mesh, v_cap: Optional[int] = None,
              f_cap: Optional[int] = None, quantum: int = 1024,
              K: int = NEIGHBORSIZE, hilbert_faces: bool = True,
              device='cuda') -> MeshArrays:
    """Pad a host TriangleMesh into MeshArrays on ``device``.

    ``hilbert_faces`` reorders the faces by the Hilbert code of their
    centroids so spatially close faces are index-contiguous — the
    invariant the windowed correspondence search relies on (the fit
    loop passes False because ``spatial_sort`` already did it)."""
    v = np.asarray(mesh.vertices, dtype=np.float32)
    f = np.asarray(mesh.faces, dtype=np.int32)
    if hilbert_faces and len(f) > 64:
        from .ordering import hilbert_order
        fc = v[f].mean(1)
        f = np.ascontiguousarray(f[hilbert_order(fc)])
    V, F = v.shape[0], f.shape[0]
    Vp = v_cap or round_up_bucket(V, quantum)
    Fp = f_cap or round_up_bucket(F, quantum)
    if Vp < V or Fp < F:
        raise ValueError('capacity below current size')

    pos = np.zeros((Vp, 3), np.float32)
    pos[:V] = v
    v_mask = np.zeros(Vp, bool)
    v_mask[:V] = True
    faces = np.zeros((Fp, 3), np.int32)
    faces[:F] = f
    f_mask = np.zeros(Fp, bool)
    f_mask[:F] = True

    from .. import native
    nbr_v = np.full((Vp, K), -1, np.int32)
    nbr_f = np.full((Vp, K), -1, np.int32)
    fn = np.full((Fp, 3), -1, np.int32)
    native.build_tables(f, V, K, out=(nbr_v, nbr_f, fn))

    host = {'faces': faces, 'f_mask': f_mask, 'nbr_v': nbr_v,
            'nbr_f': nbr_f, 'face_nbrs': fn, 'V': V, 'F': F}

    def t(a):
        return torch.from_numpy(a).to(device)

    return MeshArrays(t(pos), t(v_mask), t(faces), t(f_mask), t(nbr_v),
                      t(nbr_f), t(fn), host=host)


def incidence_table(faces: np.ndarray, f_mask: np.ndarray,
                    n_vertices: int, K: int = FOLD_K):
    """(Vp, K) table of flat row ids r (into faces.reshape(-1)) with
    ``faces.reshape(-1)[r] == v`` — the gather-side inverse of the
    faces -> vertices fold.  Returns (inc (Vp, K) i32 -1-padded,
    ov_rows (O,) i32, ov_verts (O,) i32), the overflow lists carrying
    the incident rows of vertices with valence > K."""
    from .. import native
    return native.incidence(faces, f_mask, n_vertices, K=K)


class GatherTables(NamedTuple):
    """Index streams of one padded topology for the row-gather kernel.

    tri_idx   : (3 Fp,) i32 — faces.reshape(-1) (tri and S gathers)
    ncc_idx   : (NCC_K Vp,) i32 — k-major one-ring stream, slot k of
                vertex v at row k Vp + v, -1 entries clamped to 0
    ncc_care  : (NCC_K, Vp) bool — which stream rows are real neighbours
    ncc_ov    : None or (ov_v, ov_u) i64 — (vertex, neighbour) pairs of
                the slots >= NCC_K
    fold_idx  : (FOLD_K Vp,) i32 — vertex-major incident corner rows
                (row v FOLD_K + k), -1 entries clamped to 0
    fold_care : (Vp, FOLD_K) bool
    fold_ov   : None or (ov_rows, ov_verts) i64 — incident rows of
                vertices with valence > FOLD_K
    """
    tri_idx: torch.Tensor
    ncc_idx: torch.Tensor
    ncc_care: torch.Tensor
    ncc_ov: Optional[tuple]
    fold_idx: torch.Tensor
    fold_care: torch.Tensor
    fold_ov: Optional[tuple]


def gather_tables(ma: MeshArrays) -> GatherTables:
    """Build the :class:`GatherTables` of a padded topology from the
    host copies ``from_mesh`` kept."""
    h = ma.host
    dev = ma.positions.device
    Vp = ma.positions.shape[0]
    nbr = h['nbr_v']

    def t(a, dtype=None):
        # a writable copy only when needed (host tables may be views of
        # read-only arrays)
        x = torch.from_numpy(np.require(a, requirements=['C', 'W'])).to(dev)
        return x if dtype is None else x.to(dtype)

    def pairs(a, b):
        if len(a) == 0:
            return None
        return (t(a, torch.int64), t(b, torch.int64))

    ncc = nbr[:, :NCC_K]
    ncc_care = (ncc >= 0).T                           # (NCC_K, Vp)
    ncc_idx = np.clip(ncc, 0, None).T.reshape(-1)
    ev, ek = np.nonzero(nbr[:, NCC_K:] >= 0)
    ncc_ov = pairs(ev, nbr[:, NCC_K:][ev, ek])

    inc, ov_r, ov_v = incidence_table(h['faces'], h['f_mask'], Vp)
    fold_idx = np.clip(inc, 0, None).reshape(-1)
    return GatherTables(
        tri_idx=t(h['faces'].reshape(-1)),
        ncc_idx=t(ncc_idx.astype(np.int32)),
        ncc_care=t(ncc_care),
        ncc_ov=ncc_ov,
        fold_idx=t(fold_idx.astype(np.int32)),
        fold_care=t(inc >= 0),
        fold_ov=pairs(ov_r, ov_v))
