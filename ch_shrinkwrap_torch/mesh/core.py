"""SoA triangle mesh with derived halfedge connectivity.

This is the rebuild of the PYME ``TriangleMesh`` base class the
reference depends on (cimported at
ch_shrinkwrap/_membrane_mesh.pxd:3) — halfedge arrays,
neighbor tables, normals, remeshing, repair, component analysis and STL
I/O — re-designed for a TPU-first pipeline:

* canonical state is always-compact ``vertices (V, 3) float32`` and
  ``faces (F, 3) int32`` arrays — no tombstones, trivially padded into
  static-shape device buffers;
* halfedge connectivity (vertex/face/twin/next/prev), the fixed-valence
  neighbor table (``NEIGHBORSIZE = 20``, same bound as the reference's
  ``membrane_mesh_utils.h:26``), normals, areas and components are
  *derived* caches, recomputed vectorized after each topology change;
* topology edits (remesh passes, vertex removal, hole filling) emit a
  new (V, F) pair rather than editing in place;
* the twins, components, fan test, one-ring smoothing, repair and
  Hilbert codes run in the native host engine (``native/``) at every
  mesh size.
"""

from __future__ import annotations

import numpy as np

from .. import native

NEIGHBORSIZE = 20

_DERIVED = ('_he', '_vertex_neighbors_cache', '_face_normals_cache',
            '_face_areas_cache', '_vertex_normals_cache',
            '_vertex_components_cache', '_face_components_cache')


class HalfedgeTables:
    """Derived halfedge arrays for a compact (V, F) triangle soup.

    Halfedge ``3*f + k`` runs from ``faces[f, k]`` to
    ``faces[f, (k+1) % 3]``.  ``twin`` is -1 on boundary or non-manifold
    edges.
    """

    __slots__ = ('vertex', 'src', 'face', 'twin', 'next', 'prev',
                 'vertex_halfedge', 'nonmanifold_edges',
                 '_positions', '_length')

    def __init__(self, positions: np.ndarray, faces: np.ndarray):
        F = faces.shape[0]
        nhe = 3 * F

        self.src = faces.ravel().astype(np.int32, copy=False)
        self.vertex = faces[:, [1, 2, 0]].ravel()  # to-vertex
        self.face = np.repeat(np.arange(F, dtype=np.int32), 3)
        # halfedge 3f+k: next is 3f+(k+1)%3, prev is 3f+(k+2)%3
        base = np.arange(nhe, dtype=np.int32)
        nxt = base + 1
        nxt[2::3] -= 3
        prv = base - 1
        prv[0::3] += 3
        self.next = nxt
        self.prev = prv
        self._positions = positions
        self._length = None

        self.twin, self.nonmanifold_edges, self.vertex_halfedge = \
            native.halfedge_twins(faces, positions.shape[0])

    @property
    def length(self) -> np.ndarray:
        """Per-halfedge edge length, computed lazily (repair and the
        component passes never touch it; remesh decisions do)."""
        if self._length is None:
            p = self._positions
            d = p[self.vertex] - p[self.src]
            self._length = np.sqrt((d * d).sum(1)).astype(np.float32)
        return self._length

    @length.setter
    def length(self, value):
        self._length = value


class TriangleMesh:
    """Compact triangle mesh with lazily derived halfedge connectivity.

    Parameters
    ----------
    vertices : (V, 3) float array
    faces : (F, 3) int array, CCW winding, outward normals
    """

    def __init__(self, vertices=None, faces=None, mesh=None, **kwargs):
        if mesh is not None:
            vertices = np.array(mesh.vertices, dtype=np.float32, copy=True)
            faces = np.array(mesh.faces, dtype=np.int32, copy=True)
        self._vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self._faces = np.ascontiguousarray(faces, dtype=np.int32)
        self._invalidate()
        self.extra_vertex_data = {}
        self.vertex_properties = []
        self.vertex_vector_properties = []
        for key, value in kwargs.items():
            setattr(self, key, value)

    # ------------------------------------------------------------------
    # canonical state

    @property
    def vertices(self) -> np.ndarray:
        """(V, 3) float32 vertex positions (always compact/valid)."""
        return self._vertices

    @vertices.setter
    def vertices(self, value):
        self._vertices = np.ascontiguousarray(value, dtype=np.float32)
        self._invalidate_geometry()

    @property
    def faces(self) -> np.ndarray:
        """(F, 3) int32 vertex indices per face."""
        return self._faces

    def set_positions(self, positions):
        """Update vertex positions, keeping topology (geometry caches drop)."""
        self._vertices = np.ascontiguousarray(positions, dtype=np.float32)
        self._invalidate_geometry()

    def set_topology(self, vertices, faces):
        """Replace the mesh wholesale (the rebuild-style edit primitive)."""
        self._vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self._faces = np.ascontiguousarray(faces, dtype=np.int32)
        self._invalidate()

    def _invalidate(self):
        for name in _DERIVED:
            setattr(self, name, None)
        # monotone topology revision: device-side caches keyed on this
        # survive position-only updates (set_positions) but never a
        # topology edit
        self._topo_rev = getattr(self, '_topo_rev', 0) + 1
        self._geom_rev = getattr(self, '_geom_rev', 0) + 1

    def _invalidate_geometry(self):
        # positions moved but topology unchanged: lengths/normals stale,
        # connectivity still valid except edge lengths stored on self._he
        self._geom_rev = getattr(self, '_geom_rev', 0) + 1
        self._face_normals_cache = None
        self._face_areas_cache = None
        self._vertex_normals_cache = None
        if self._he is not None:
            self._he._positions = self._vertices
            self._he._length = None

    # ------------------------------------------------------------------
    # derived connectivity

    @property
    def halfedges(self) -> HalfedgeTables:
        if self._he is None:
            self._he = HalfedgeTables(self._vertices, self._faces)
        return self._he

    @property
    def vertex_neighbors(self) -> np.ndarray:
        """(V, NEIGHBORSIZE) int32 neighbor *vertex* indices, -1 padded.

        NB the reference stores neighbor halfedge indices
        (_membrane_mesh.pyx:50-54) and maps through
        ``_halfedges['vertex']``; we store the neighbor vertices
        directly — same information, one less indirection.
        """
        if self._vertex_neighbors_cache is None:
            he = self.halfedges
            V = self._vertices.shape[0]
            order = np.argsort(he.src, kind='stable')
            ssrc = he.src[order]
            starts = np.searchsorted(ssrc, np.arange(V))
            rank = np.arange(len(ssrc)) - starts[ssrc]
            tbl = np.full((V, NEIGHBORSIZE), -1, np.int32)
            ok = rank < NEIGHBORSIZE
            tbl[ssrc[ok], rank[ok]] = he.vertex[order[ok]]
            self._vertex_neighbors_cache = tbl
        return self._vertex_neighbors_cache

    @property
    def valence(self) -> np.ndarray:
        """Number of outgoing halfedges (== incident faces) per vertex."""
        return np.bincount(self.halfedges.src,
                           minlength=self._vertices.shape[0]).astype(np.int32)

    # ------------------------------------------------------------------
    # geometry

    @property
    def face_normals(self) -> np.ndarray:
        """(F, 3) unit outward normals ((v1-v0) x (v2-v0) convention)."""
        if self._face_normals_cache is None:
            self._compute_face_geometry()
        return self._face_normals_cache

    @property
    def face_areas(self) -> np.ndarray:
        if self._face_areas_cache is None:
            self._compute_face_geometry()
        return self._face_areas_cache

    def _compute_face_geometry(self):
        tri = self._vertices[self._faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        nn = np.sqrt((n * n).sum(1))
        self._face_areas_cache = (0.5 * nn).astype(np.float32)
        self._face_normals_cache = (n / np.maximum(nn, 1e-12)[:, None]
                                    ).astype(np.float32)

    @property
    def vertex_normals(self) -> np.ndarray:
        """(V, 3) unit normals: corner-angle-weighted mean of incident
        face normals (matches ops.normals.vertex_normals on device)."""
        if self._vertex_normals_cache is None:
            fn = self.face_normals
            tri = self._vertices[self._faces]
            e_next = tri[:, [1, 2, 0]] - tri
            e_prev = tri[:, [2, 0, 1]] - tri
            dot = (e_next * e_prev).sum(-1)
            sin = np.linalg.norm(np.cross(e_next, e_prev), axis=-1)
            ang = np.arctan2(sin, dot)
            vn = np.zeros_like(self._vertices)
            for k in range(3):
                np.add.at(vn, self._faces[:, k], fn * ang[:, k:k + 1])
            norm = np.sqrt((vn * vn).sum(1))
            self._vertex_normals_cache = (vn / np.maximum(norm, 1e-12)[:, None]
                                          ).astype(np.float32)
        return self._vertex_normals_cache

    @property
    def _mean_edge_length(self) -> float:
        """Mean halfedge length (== unique-edge mean on closed meshes).

        Cached per geometry revision — the fit loop reads this at
        every remesh boundary (edge-length schedule logging) and the
        old form built the full halfedge tables for it (~0.2 s per
        boundary at 300k faces).  When the tables aren't already built,
        a native single pass gives the identical value: the 3F face
        edges ARE the halfedges."""
        if not self._faces.size:
            return 0.0
        key = (self._topo_rev, self._geom_rev)
        cached = getattr(self, '_mean_edge_cache', None)
        if cached is not None and cached[0] == key:
            return cached[1]
        if self._he is not None:
            val = float(np.mean(self._he.length))
        else:
            val = native.mean_edge(self._vertices, self._faces)
        self._mean_edge_cache = (key, val)
        return val

    def area(self) -> float:
        return float(self.face_areas.sum())

    def volume(self) -> float:
        """Signed volume (positive for outward-oriented closed surfaces)."""
        tri = self._vertices[self._faces].astype(np.float64)
        return float(np.einsum('ij,ij->', tri[:, 0],
                               np.cross(tri[:, 1], tri[:, 2])) / 6.0)

    # ------------------------------------------------------------------
    # topology metrics (parity with reference MeshProperties,
    # surface_feature_extraction.py:144-167)

    @property
    def euler_characteristic(self) -> int:
        V = self._vertices.shape[0]
        F = self._faces.shape[0]
        he = self.halfedges
        n_interior = int((he.twin >= 0).sum()) // 2
        n_boundary = int((he.twin < 0).sum())
        E = n_interior + n_boundary
        return V - E + F

    @property
    def genus(self) -> float:
        return (2 - self.euler_characteristic - self.n_boundary_loops) / 2

    @property
    def n_boundary_loops(self) -> int:
        return len(self.boundary_loops())

    @property
    def is_manifold(self) -> bool:
        he = self.halfedges
        if he.nonmanifold_edges.any():
            return False
        if (he.twin < 0).any():   # boundary -> not closed-manifold
            return False
        return not self._has_nonmanifold_vertices()

    def _has_nonmanifold_vertices(self) -> bool:
        """A vertex whose incident faces don't form a single fan."""
        he = self.halfedges
        return native.has_nonmanifold_vertices(
            he.src, he.vertex, he.twin, he.next, self._vertices.shape[0])

    def connected_components(self):
        """(labels_per_vertex, n_components) over the edge graph."""
        if self._vertex_components_cache is None:
            self._vertex_components_cache = native.vertex_components(
                self._faces, self._vertices.shape[0])
        return self._vertex_components_cache

    @property
    def face_components(self) -> np.ndarray:
        if self._face_components_cache is None:
            labels, _ = self.connected_components()
            self._face_components_cache = labels[self._faces[:, 0]]
        return self._face_components_cache

    def boundary_loops(self):
        """List of halfedge-index arrays, each an ordered boundary loop."""
        he = self.halfedges
        boundary = np.flatnonzero(he.twin < 0)
        if len(boundary) == 0:
            return []
        # walk: from boundary halfedge h (src->vertex), the next boundary
        # halfedge starts at he.vertex[h]: rotate around that vertex over
        # twins until the outgoing edge with no twin on its prev..
        # Simpler: boundary halfedges form loops linked by matching
        # src == vertex of predecessor; build map vertex -> boundary he.
        src_map = {}
        for h in boundary:
            src_map.setdefault(int(he.src[h]), []).append(int(h))
        visited = set()
        loops = []
        for h0 in boundary:
            h0 = int(h0)
            if h0 in visited:
                continue
            loop = []
            h = h0
            guard = 0
            while h not in visited and guard <= len(boundary):
                visited.add(h)
                loop.append(h)
                cands = src_map.get(int(he.vertex[h]), [])
                nxt = None
                for c in cands:
                    if c not in visited or (c == h0 and len(loop) > 1):
                        nxt = c
                        break
                if nxt is None or nxt == h0:
                    break
                h = nxt
                guard += 1
            loops.append(np.array(loop, dtype=np.int32))
        return loops

    # ------------------------------------------------------------------
    # batch topology edits

    def keep_faces(self, face_mask):
        """Retain only masked faces; drop unreferenced vertices."""
        new_faces = self._faces[face_mask]
        self._compact(new_faces)

    def unsafe_remove_vertices(self, verts):
        """Remove given vertices and every face touching them.

        Parity with PYME ``unsafe_remove_vertices`` as used by
        ``remove_necks`` (_membrane_mesh.pyx:1215); leaves boundary
        holes behind — call :meth:`repair` afterwards.
        """
        bad = np.zeros(self._vertices.shape[0], dtype=bool)
        bad[np.asarray(verts, dtype=np.int64)] = True
        face_bad = bad[self._faces].any(axis=1)
        self._compact(self._faces[~face_bad])

    def _compact(self, new_faces):
        used = np.unique(new_faces.ravel()) if new_faces.size else \
            np.zeros(0, np.int64)
        remap = np.full(self._vertices.shape[0], -1, np.int64)
        remap[used] = np.arange(len(used))
        extra = {k: v[used] for k, v in self.extra_vertex_data.items()}
        self.set_topology(self._vertices[used],
                          remap[new_faces].astype(np.int32))
        self.extra_vertex_data = extra

    def spatial_sort(self):
        """Reorder vertices and faces along a Hilbert curve.

        Vertex/face order carries no semantics, but index locality is
        worth large factors on TPU: locally-sorted gather/scatter
        indices measured 8x (gather) and 93x (segment-sum) faster than
        random ones at 3M rows (BASELINE.md).  The solver's v_idx
        tables inherit locality from this ordering.
        """
        from ..ops.ordering import hilbert_order
        if self._vertices.shape[0] < 64:
            return
        vperm = hilbert_order(self._vertices)
        inv = np.empty(len(vperm), np.int64)
        inv[vperm] = np.arange(len(vperm))
        new_v = self._vertices[vperm]
        new_f = inv[self._faces].astype(np.int32)
        # fused native centroid+code pass (bit-exact twin of
        # hilbert_order(new_v[new_f].mean(1)); ~110 -> ~8 ms at 164k, a
        # per-remesh-boundary cost in the fit loop)
        fp = np.argsort(native.face_hilbert_codes(new_v, new_f),
                        kind='stable')
        new_f = np.ascontiguousarray(new_f[fp])
        extra = {k: v[vperm] for k, v in self.extra_vertex_data.items()}
        self.set_topology(new_v, new_f)
        self.extra_vertex_data = extra

    def repair(self, max_passes=8, remove=None):
        """Close boundary holes and restore edge-manifoldness.

        Counterpart of PYME ``repair`` used after vertex removal
        (_membrane_mesh.pyx:1216).  Iterates: drop degenerate /
        duplicate faces and faces on over-shared (non-manifold) edges,
        split boundary walks into simple cycles and zig-zag fill them,
        drop debris components — until the boundary is gone or passes
        run out; then splits pinch points and drops the debris that
        frees.

        ``remove``: vertices to delete first, with every face touching
        them (:meth:`unsafe_remove_vertices`), leaving the holes this
        closes.  Returns the counts of ``native.REPAIR_COUNTS``.

        One native call does the removal and every pass on one
        halfedge structure, revisiting only the faces around the holes;
        its arrays equal those of the numpy reference passes
        (``tests/torch_host_reference.py``) bit for bit.  The numpy
        passes erode a boundary walk that does not close; after the
        hygiene every walk closes (each vertex has as many outgoing as
        incoming boundary halfedges), so the native call raises instead
        of eroding.

        Two departures from the JAX package's ``repair``, which returns
        before the split when the holes close (and so can leave pinch
        points, and with them a non-manifold surface): the split always
        runs, and when a boundary remains after it (a pinch point on a
        hole's ring can keep the fill from closing the hole) the passes
        run once more.
        """
        mask = None
        if remove is not None:
            mask = np.zeros(self._vertices.shape[0], dtype=bool)
            mask[np.asarray(remove, dtype=np.int64)] = True
        faces, vmap, counts = native.repair(
            self._faces, self._vertices.shape[0], mask, max_passes)
        if faces is not None:
            extra = {k: v[vmap] for k, v in self.extra_vertex_data.items()}
            self.set_topology(self._vertices[vmap], faces)
            self.extra_vertex_data = extra
        return counts

    def remove_inner_surfaces(self):
        """Remove connected components nested inside larger components.

        Counterpart of PYME ``remove_inner_surfaces``
        (_membrane_mesh.pyx:1219).  Components are ranked by absolute
        enclosed volume; a component whose centroid lies inside a larger
        kept component (even-odd ray cast), or whose orientation is
        inverted (negative signed volume), is dropped.
        """
        labels, n = self.connected_components()
        if n <= 1:
            # single component: nothing nested; keep as is
            return
        flabels = self.face_components
        tri = self._vertices[self._faces].astype(np.float64)
        svol = np.einsum('ij,ij->i', tri[:, 0], np.cross(tri[:, 1], tri[:, 2])) / 6.0
        comp_vol = np.zeros(n)
        np.add.at(comp_vol, flabels, svol)

        order = np.argsort(-np.abs(comp_vol))
        keep = np.zeros(n, dtype=bool)
        for c in order:
            if comp_vol[c] <= 0:
                continue
            centroid = self._vertices[labels == c].mean(0)
            inside = False
            for k in np.flatnonzero(keep):
                if np.abs(comp_vol[k]) <= np.abs(comp_vol[c]):
                    continue
                if _point_inside(centroid, tri[flabels == k]):
                    inside = True
                    break
            keep[c] = not inside
        if keep.all():
            return
        self.keep_faces(keep[flabels])

    def remove_degenerate_components(self, min_faces=4):
        """Drop connected components with fewer than ``min_faces`` faces.

        A closed orientable 2-manifold needs at least 4 faces (the
        tetrahedron); 2-face "pillows" (two faces glued back-to-back,
        V−E+F = 2) are numeric artifacts of edge collapse on tiny
        fragments — the link condition legitimately allows collapsing a
        tetrahedron component down to one (observed in the 99-iter
        north-star fit: a 3-vertex pillow split off by the final growth
        remesh left euler=4).  The reference has no direct counterpart
        because its sequential collapse refuses sub-tetrahedron
        components via valence guards (_skeleton_mesh.pyx:334-499).
        Returns the number of components removed."""
        labels, n = self.connected_components()
        if n <= 1:
            return 0
        flabels = self.face_components
        counts = np.bincount(flabels, minlength=n)
        bad = counts < min_faces
        if not bad.any() or bad.all():
            return 0
        self.keep_faces(~bad[flabels])
        return int(bad.sum())

    # ------------------------------------------------------------------
    # data smoothing

    def smooth_per_vertex_data(self, data, n_iter=1):
        """Average scalar per-vertex data over the one-ring (incl. self):
        (V,) data read as float32, accumulated in float64 in
        neighbour-slot order; returns (V,) float32."""
        return native.smooth_vertex_data(data, self.vertex_neighbors,
                                         n_iter=n_iter)

    # ------------------------------------------------------------------
    # I/O

    def to_stl(self, filename):
        from . import io as mesh_io
        mesh_io.save_stl(filename, self._vertices, self._faces)

    def to_ply(self, filename, colors=None):
        from . import io as mesh_io
        mesh_io.save_ply(filename, self._vertices, self._faces, colors)

    @classmethod
    def from_stl(cls, filename, **kw):
        from . import io as mesh_io
        v, f = mesh_io.load_stl(filename)
        return cls(v, f, **kw)

    @classmethod
    def from_np_stl(cls, v, f, **kw):
        return cls(v, f, **kw)


def _point_inside(point, tris) -> bool:
    """Even-odd ray cast (+x direction) against a triangle soup."""
    p = np.asarray(point, dtype=np.float64)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    # Möller–Trumbore with ray direction (1, 0, 0)
    e1 = v1 - v0
    e2 = v2 - v0
    d = np.array([1.0, 0.0, 0.0])
    h = np.cross(np.broadcast_to(d, e2.shape), e2)
    a = np.einsum('ij,ij->i', e1, h)
    ok = np.abs(a) > 1e-12
    f = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)
    s = p[None, :] - v0
    u = f * np.einsum('ij,ij->i', s, h)
    q = np.cross(s, e1)
    v = f * q[:, 0]  # dot with d = x-component
    t = f * np.einsum('ij,ij->i', e2, q)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-9)
    return bool(hit.sum() % 2)
