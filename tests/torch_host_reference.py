"""The numpy reference of the port's host repair and neighbour tables.
Holds no tests.

Numpy and scipy only: nothing here calls the native host engine
(``ch_shrinkwrap_torch.native``), and no module of the package imports
this one.

* :class:`ReferenceMesh` is a ``TriangleMesh`` whose halfedge twins and
  components come from numpy and scipy (:func:`halfedge_tables`,
  :func:`vertex_components`) and whose :meth:`ReferenceMesh.repair`
  runs the repair as numpy passes over the whole mesh.
  ``TriangleMesh.repair`` (one ``native.repair`` call) must give its
  arrays and counts bit for bit (``tests/test_torch_repair.py``).  Two
  departures from the JAX package's repair are the port's by design:
  the pinch-point split always runs, and the passes run once more when
  a boundary remains after it.
* :func:`neighbor_tables` and :func:`face_adjacency` are the numpy forms
  of ``native.build_tables``.

The engine's other primitives (twins, components, the fan test, the
one-ring smoothing, Hilbert codes) are held to the JAX package's numpy
branches instead (``tests/test_torch_host.py``).
"""

from types import SimpleNamespace

import numpy as np

from ch_shrinkwrap_torch.mesh.core import NEIGHBORSIZE, TriangleMesh
from ch_shrinkwrap_torch.native import REPAIR_COUNTS


def halfedge_tables(faces, n_vertices):
    """The halfedge arrays of ``mesh.core.HalfedgeTables`` that the
    repair reads (src, vertex, face, next, twin, nonmanifold_edges),
    the twins matched by sorting directed-edge keys."""
    F = faces.shape[0]
    nhe = 3 * F
    V = n_vertices
    src = faces.ravel().astype(np.int32, copy=False)
    vertex = faces[:, [1, 2, 0]].ravel()
    # halfedge 3f+k: next is 3f+(k+1)%3
    nxt = np.arange(nhe, dtype=np.int32) + 1
    nxt[2::3] -= 3

    key = src.astype(np.int64) * V + vertex
    tkey = vertex.astype(np.int64) * V + src
    order = np.argsort(key, kind='stable')
    skey = key[order]
    pos = np.searchsorted(skey, tkey)
    pos_c = np.clip(pos, 0, nhe - 1) if nhe else pos
    cand = order[pos_c] if nhe else np.zeros(0, np.int32)
    twin = np.where((pos < nhe) & (skey[pos_c] == tkey), cand, -1)

    # Non-manifold: a directed edge that appears more than once makes
    # twin matching ambiguous; disconnect all copies.
    dup = np.zeros(nhe, dtype=bool)
    if nhe:
        same = skey[1:] == skey[:-1]
        dup_sorted = np.zeros(nhe, dtype=bool)
        dup_sorted[1:] |= same
        dup_sorted[:-1] |= same
        dup[order] = dup_sorted
    dup_t = dup | (twin >= 0) & dup[np.clip(twin, 0, None)]
    twin = np.where(dup_t, -1, twin).astype(np.int32)
    # a twin must point back; if not (one side dup-marked), sever
    back = np.full(nhe, -1, np.int32)
    has = twin >= 0
    back[has] = twin[twin[has]]
    twin = np.where(has & (back != np.arange(nhe, dtype=np.int32)),
                    -1, twin)
    return SimpleNamespace(
        src=src, vertex=vertex, face=np.repeat(np.arange(F, dtype=np.int32),
                                               3),
        next=nxt, twin=twin, nonmanifold_edges=dup)


def vertex_components(he, n_vertices):
    """(labels, n_components) over the edge graph of the halfedges."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    g = coo_matrix((np.ones(len(he.src), np.int8), (he.src, he.vertex)),
                   shape=(n_vertices, n_vertices))
    n, labels = connected_components(g, directed=False)
    return labels, n


class ReferenceMesh(TriangleMesh):
    """``TriangleMesh`` with numpy twins and scipy components, and the
    repair as numpy passes over the whole mesh."""

    @property
    def halfedges(self):
        if self._he is None:
            self._he = halfedge_tables(self._faces, self._vertices.shape[0])
        return self._he

    def connected_components(self):
        if self._vertex_components_cache is None:
            self._vertex_components_cache = vertex_components(
                self.halfedges, self._vertices.shape[0])
        return self._vertex_components_cache

    def repair(self, max_passes=8, remove=None):
        """``TriangleMesh.repair`` as numpy passes: the same arguments,
        the same counts."""
        counts = dict.fromkeys(REPAIR_COUNTS, 0)
        if remove is not None:
            self.unsafe_remove_vertices(remove)
        for _ in range(2):
            self._repair_passes(max_passes, counts)
            if self._faces.size == 0:
                break
            counts['split_vertices'] += self.split_pinched_vertices()
            self._drop_debris()
            if not self.boundary_loops():
                break
        return counts

    def _repair_passes(self, max_passes, counts):
        """The JAX package's repair passes, up to ``max_passes``; adds
        its work to ``counts``."""
        for _ in range(max_passes):
            f = self._faces
            if f.size == 0:
                return
            # degenerate + duplicate faces
            degen = ((f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2])
                     | (f[:, 0] == f[:, 2]))
            key = np.sort(f, axis=1)
            if self._vertices.shape[0] < (1 << 21):
                # pack the sorted triple into one int64 (unique on a
                # packed key is ~10x unique(axis=0) at 300k faces)
                pkey = ((key[:, 0].astype(np.int64) << 42)
                        | (key[:, 1].astype(np.int64) << 21)
                        | key[:, 2].astype(np.int64))
                _, first_idx = np.unique(pkey, return_index=True)
            else:
                _, first_idx = np.unique(key, axis=0, return_index=True)
            dup = np.ones(len(f), dtype=bool)
            dup[first_idx] = False
            # faces on non-manifold undirected edges (>2 incidences)
            a = f
            b = f[:, [1, 2, 0]]
            lo = np.minimum(a, b)
            hi = np.maximum(a, b)
            ekey = (lo.astype(np.int64) << 32 | hi.astype(np.int64)).ravel()
            uniq, inv, n_inc = np.unique(ekey, return_inverse=True,
                                         return_counts=True)
            over = (n_inc[inv] > 2).reshape(f.shape).any(1)
            bad = degen | dup | over
            if bad.any():
                self._compact(f[~bad])
                counts['passes'] += 1
                continue

            if self._drop_debris():
                counts['passes'] += 1
                continue

            loops = self.boundary_loops()
            if not loops:
                break
            he = self.halfedges
            new_tris = []
            erode = set()
            counts['holes'] += len(loops)
            counts['passes'] += 1
            for loop in loops:
                ring = he.src[loop]
                closed = (len(ring) >= 3
                          and he.vertex[loop[-1]] == ring[0])
                if closed:
                    for cyc in _simple_cycles(ring):
                        if len(cyc) >= 3:
                            new_tris.append(zig_zag_triangulate(cyc[::-1]))
                else:
                    erode.update(he.face[loop].tolist())
            faces = self._faces
            if erode:
                keep = np.ones(len(faces), dtype=bool)
                keep[list(erode)] = False
                faces = faces[keep]
            if new_tris:
                faces = np.vstack([faces] + new_tris)
                counts['faces_added'] += sum(len(t) for t in new_tris)
            if not erode and not new_tris:
                # unfixable ring shapes: erode everything on a boundary
                bset = np.unique(he.face[np.flatnonzero(he.twin < 0)])
                keep = np.ones(len(faces), dtype=bool)
                keep[bset] = False
                faces = faces[keep]
            self._compact(np.asarray(faces, dtype=np.int32))

    def _drop_debris(self):
        """Drop components of fewer than 8 faces; True when any went."""
        _, n = self.connected_components()
        if n > 1:
            fl = self.face_components
            sizes = np.bincount(fl, minlength=n)
            if (sizes < 8).any():
                self.keep_faces(sizes[fl] >= 8)
                return True
        return False

    def split_pinched_vertices(self):
        """Duplicate vertices whose incident faces form more than one
        fan (pinch points), restoring vertex-manifoldness; a copy
        carries its vertex's ``extra_vertex_data``.  Returns the number
        of copies."""
        he = self.halfedges
        E = len(he.src)
        if E == 0:
            return 0
        # fan labels: outgoing halfedges h and next[twin[h]] share a fan
        labels = np.arange(E, dtype=np.int64)
        has_twin = he.twin >= 0
        p1 = np.where(has_twin, he.next[np.clip(he.twin, 0, None)],
                      np.arange(E))
        # inverse partner: h <- the halfedge whose p1 is h
        inv = np.full(E, -1, np.int64)
        inv[p1[has_twin]] = np.flatnonzero(has_twin)
        for _ in range(64):
            new = np.minimum(labels, labels[p1])
            valid_inv = inv >= 0
            new[valid_inv] = np.minimum(new[valid_inv],
                                        labels[inv[valid_inv]])
            if (new == labels).all():
                break
            labels = new

        # group (src, fan) -> vertex instance
        key = he.src.astype(np.int64) << 32 | labels
        uniq, grp = np.unique(key, return_inverse=True)
        grp_src = (uniq >> 32).astype(np.int64)
        # first group per src keeps the original id; extras get new ids
        # (uniq is sorted with src in the high bits, so the first
        # occurrence of each src is its first group)
        _, first_pos = np.unique(grp_src, return_index=True)
        keep_mask = np.zeros(len(uniq), dtype=bool)
        keep_mask[first_pos] = True
        if keep_mask.all():
            return 0
        new_id = np.where(keep_mask, grp_src, -1)
        extra = np.flatnonzero(new_id < 0)
        new_id[extra] = self._vertices.shape[0] + np.arange(len(extra))
        new_positions = np.vstack([self._vertices,
                                   self._vertices[grp_src[extra]]])
        # rewrite face corners: corner (f, k) owns outgoing halfedge 3f+k
        new_faces = new_id[grp].reshape(-1, 3).astype(np.int32)
        extra_data = {k: np.concatenate([v, v[grp_src[extra]]])
                      for k, v in self.extra_vertex_data.items()}
        self.set_topology(new_positions, new_faces)
        self.extra_vertex_data = extra_data
        return len(extra)


def _simple_cycles(ring):
    """Split a closed vertex walk with repeated vertices into simple
    cycles (pinch points become cycle boundaries)."""
    out = []
    stack = []
    pos = {}
    for v in ring:
        v = int(v)
        if v in pos:
            i = pos[v]
            cyc = stack[i:]
            for u in cyc:
                pos.pop(u, None)
            del stack[i:]
            if len(cyc) >= 3:
                out.append(np.array(cyc, dtype=ring.dtype))
        pos[v] = len(stack)
        stack.append(v)
    if len(stack) >= 3:
        out.append(np.array(stack, dtype=ring.dtype))
    return out


def zig_zag_triangulate(ring):
    """Triangulate a vertex cycle by alternating ends (zig-zag).

    Counterpart of PYME ``_zig_zag_triangulation`` used in hole punching
    (_membrane_mesh.pyx:807): consumes the polygon from both ends toward
    the middle, producing n-2 triangles with reasonable aspect ratios.
    """
    n = len(ring)
    tris = []
    lo, hi = 0, n - 1
    take_lo = True
    while hi - lo >= 2:
        if take_lo:
            tris.append((ring[lo], ring[lo + 1], ring[hi]))
            lo += 1
        else:
            tris.append((ring[lo], ring[hi - 1], ring[hi]))
            hi -= 1
        take_lo = not take_lo
    return np.array(tris, dtype=np.int32)


def neighbor_tables(faces, n_vertices, K=NEIGHBORSIZE):
    """(V, K) neighbour-vertex and neighbour-face tables from (F, 3)
    faces: slot k of vertex v holds the head of one outgoing halfedge
    v->u and the face on that halfedge's left."""
    src = faces.ravel()
    dst = faces[:, [1, 2, 0]].ravel()
    fidx = np.repeat(np.arange(faces.shape[0], dtype=np.int64), 3)
    order = np.argsort(src, kind='stable')
    ssrc = src[order]
    starts = np.searchsorted(ssrc, np.arange(n_vertices))
    rank = np.arange(len(ssrc)) - starts[ssrc]
    nbr_v = np.full((n_vertices, K), -1, np.int32)
    nbr_f = np.full((n_vertices, K), -1, np.int32)
    ok = rank < K
    nbr_v[ssrc[ok], rank[ok]] = dst[order[ok]]
    nbr_f[ssrc[ok], rank[ok]] = fidx[order[ok]]
    return nbr_v, nbr_f


def face_adjacency(faces):
    """(F, 3) edge-adjacent face ids (-1 on boundary/non-manifold)."""
    F = faces.shape[0]
    if F == 0:
        return np.zeros((0, 3), np.int32)
    src = faces.ravel().astype(np.int64)
    dst = faces[:, [1, 2, 0]].ravel().astype(np.int64)
    V = int(faces.max()) + 1
    key = src * V + dst
    tkey = dst * V + src
    order = np.argsort(key, kind='stable')
    skey = key[order]
    pos = np.searchsorted(skey, tkey)
    pos_c = np.clip(pos, 0, len(skey) - 1)
    cand = order[pos_c]
    ok = (pos < len(skey)) & (skey[pos_c] == tkey)
    twin_face = np.where(ok, cand // 3, -1)
    return twin_face.reshape(F, 3).astype(np.int32)
