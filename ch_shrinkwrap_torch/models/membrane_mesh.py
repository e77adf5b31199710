"""MembraneMesh — the NanoWrap model and its shrink_wrap fit.

Counterpart of the JAX package's ``models/membrane_mesh.py`` (itself a
rebuild of the reference's Cython ``MembraneMesh``,
ch_shrinkwrap/_membrane_mesh.pyx:78-1681): the host object owns the
compact mesh and the fit schedule; every CG block (to the next remesh or
punch boundary) runs ``cg_block`` on the mesh's torch device; between
blocks the host runs the topology surgery (hole punching, Gaussian-
curvature neck removal, short-edge cleanup) and the native remesh on
the edge-length schedule, then re-pads the arrays.  ``delaunay_remesh``
rebuilds the surface from the Delaunay hull of the vertices.

The public surface follows the JAX package: ``shrink_wrap`` with the
``'conjugate_gradient'`` and ``'skeleton'`` methods, the shrink prior
(``shrink_weight > 0``), the ``'final'``, ``'two'`` and ``'bucketed'``
capacity modes, curvature properties, the optimizer diagnostics
(``S0..S3``, ``point_dis``, ``rms_point_sc``, ``point_influence``),
``residual_histogram`` and ``distance_to_surface``.  With
``device_mesh`` (an int or a ``parallel.sharding.DeviceMesh``) the fit
shards the cloud over that many ranks (``parallel.sharding``).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..mesh.core import TriangleMesh
from ..mesh import remesh as _remesh
from ..ops import meshdata
from ..ops import curvature as _curv
from ..ops import correspondence as _corr
from ..ops import normals as _norm
from ..ops.ordering import fit_point_order
from ..parallel import sharding
from ..solver.shrinkwrap import CORR_ALIASES, block_call
from ..utils import tracing
from ..utils.tracing import FitTrace

logger = logging.getLogger(__name__)

DESCENT_METHODS = ['conjugate_gradient', 'skeleton']
DEFAULT_DESCENT_METHOD = 'conjugate_gradient'

KBT = _curv.KBT

# closed pieces the neck pass cuts off with fewer faces than this are
# debris: the coarsest closed surface of the package, an icosahedron,
# has 20
NECK_FRAGMENT_FACES = 20


class MembraneMesh(TriangleMesh):
    """Triangle mesh with Canham-Helfrich state and the shrink_wrap fit.

    Accepts ``(vertices, faces)`` or ``mesh=...`` plus keyword overrides
    for every optimizer/topology parameter, as the reference does
    (_membrane_mesh.pyx:79-120).  ``device`` (default ``'cuda'``) is
    where the fit's tensors live; pass ``device='cpu'`` to run the plain
    PyTorch versions of the kernels.
    """

    def __init__(self, vertices=None, faces=None, mesh=None, device='cuda',
                 **kwargs):
        # bending stiffness (kBT-scaled eV, pyx:82-84)
        self.kc = 20.0 * KBT
        self.kg = -20.0 * KBT
        self.c0 = 0.0

        # optimizer parameters (pyx:95-102)
        self.step_size = 1.0
        self.beta_1 = 0.8
        self.beta_2 = 0.7
        self.eps = 1e-8
        self.max_iter = 250
        self.remesh_frequency = 100
        self.delaunay_remesh_frequency = 150
        self.delaunay_eps = 1.0

        self.search_k = 200
        self.search_rad = 100
        self.skip_prob = 0.0
        self.smooth_curvature = True

        self.neck_threshold_low = -1e-4
        self.neck_threshold_high = 1e-2
        self.neck_first_iter = -1
        # low-side neck criterion: 'threshold' (the reference's) or
        # 'separator' (connected negative-K patches that disconnect the
        # surface, see remove_necks); the separator's candidate bound,
        # per-patch median-K bound and constriction ratio
        self.neck_detector = 'threshold'
        self.neck_separator_threshold = -1e-5
        self.neck_separator_median = -2e-4
        self.neck_separator_constriction = 0.9
        self.remesh_collapse_veto = False
        self.remesh_collapse_veto_cos = 0.5
        self.shrink_weight = 0.0
        self.truncate_at = 2 ** 31
        # skip the internal remesh of the boundary surgeries (necks,
        # short edges): the scheduled remesh follows at the same boundary
        self.defer_boundary_remesh = True

        # capacity quantum of the padded arrays.  'final' pads every
        # block to one capacity predicted from the edge-length schedule;
        # 'two' runs the growth phase at a mid rung (about half the
        # predicted final capacity) and then the final rung; 'bucketed'
        # pads each block to the power-of-two bucket above the current
        # mesh (monotone, meshdata.fit_buckets)
        self.pad_quantum = 1024
        self.capacity_mode = 'final'
        # the boundary neck diagnostic reads K from the native host
        # kernel; False computes it on the device at the end of each CG
        # block (cg_block want_curv_K)
        self.use_native_neck_k = True
        self.face_chunk = 2048
        # correspondence: 'brute' (exact), 'windowed' (K1 + K2; the JAX
        # package's 'windowed_pallas' means the same), 'grid' (hash grid,
        # cell 2x the mean edge), 'blocked' (per-block candidates), or
        # 'auto' (windowed once N*F crosses the brute-force budget)
        self.corr_method = 'auto'
        # None: one process; an int or a parallel.sharding.DeviceMesh:
        # shard the cloud over that many ranks
        self.device_mesh = None
        # padded vertex count above which the gathers run through K3
        self.ring_gather_min_verts = 32768

        self.device = torch.device(device)
        self._points = None
        self._sigma = None
        self._last_diag = None
        self._curv_state = None
        self.mdh = {}
        # a seed surface from wrap_start carries the trace of its spans
        seed_trace = getattr(mesh, 'trace', None)
        self.trace = FitTrace() if seed_trace is None \
            else seed_trace.continued()

        with self.trace.span('construct'):
            TriangleMesh.__init__(self, vertices, faces, mesh, **kwargs)

        self.vertex_properties = ['E', 'curvature_principal0',
                                  'curvature_principal1', 'point_dis',
                                  'rms_point_sc', 'point_influence']
        self.vertex_vector_properties = ['S0', 'S1', 'S2', 'S3']

    # ------------------------------------------------------------------
    # curvature state (cached, recomputed on demand)

    def _invalidate(self):
        TriangleMesh._invalidate(self)
        self._curv_state = None

    def _invalidate_geometry(self):
        TriangleMesh._invalidate_geometry(self)
        self._curv_state = None

    def _initialize_curvature_vectors(self):
        """Reference API parity (pyx:188): drop cached curvature."""
        self._curv_state = None

    def _padded_meshdata(self):
        """Padded arrays (power-of-two capacity buckets) for diagnostics
        and curvature, cached on the topology revision; a position-only
        change refreshes just the positions."""
        q = self.pad_quantum
        cached = getattr(self, '_diag_ma_cache', None)
        if cached is not None and cached[0] == self._topo_rev:
            rev, ma, geom_rev = cached
            if geom_rev != self._geom_rev:
                pos = torch.zeros_like(ma.positions)
                pos[:self.vertices.shape[0]] = torch.from_numpy(
                    self.vertices).to(pos.device)
                ma = ma._replace(positions=pos)
                self._diag_ma_cache = (rev, ma, self._geom_rev)
            return ma
        ma = meshdata.from_mesh(
            self, v_cap=meshdata.pow2_bucket(self.vertices.shape[0], q),
            f_cap=meshdata.pow2_bucket(self.faces.shape[0], q), quantum=q,
            device=self.device)
        self._diag_ma_cache = (self._topo_rev, ma, self._geom_rev)
        return ma

    def _populate_curvature_grad(self):
        ma = self._padded_meshdata()
        st = _curv.curvature_grad(
            ma.positions, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
            ma.nbr_f, kc=self.kc, kg=self.kg, c0=self.c0)
        self._curv_state = {'_dev': st}
        return self._curv_state

    def _curv(self, key):
        if self._curv_state is None:
            if key == 'K' and self.use_native_neck_k:
                # K-only fast path: the native host kernel
                from .. import native
                self._curv_state = {'_native_K': native.gaussian_k(
                    self.vertices, self.faces)}
            else:
                self._populate_curvature_grad()
        st = self._curv_state
        if key not in st:
            if key == 'K' and '_native_K' in st:
                out = st['_native_K'][:self.vertices.shape[0]]
                if self.smooth_curvature:
                    out = self.smooth_per_vertex_data(out)
                st[key] = out
                return out
            if '_dev' not in st or getattr(st['_dev'], key) is None:
                # the native K-only seed, or the CG block's K-only
                # state: repopulate fully for any other field
                st = self._populate_curvature_grad()
            V = self.vertices.shape[0]
            out = getattr(st['_dev'], key).cpu().numpy()[:V]
            if self.smooth_curvature and key in ('H', 'K', 'k_0', 'k_1'):
                out = self.smooth_per_vertex_data(out)
            st[key] = out
        return st[key]

    @property
    def curvature_mean(self):
        return self._curv('H')

    @property
    def curvature_gaussian(self):
        return self._curv('K')

    @property
    def curvature_principal0(self):
        return self._curv('k_0')

    @property
    def curvature_principal1(self):
        return self._curv('k_1')

    @property
    def eigenvector_principal0(self):
        return self._curv('e_0')

    @property
    def eigenvector_principal1(self):
        return self._curv('e_1')

    @property
    def E(self):
        return np.nan_to_num(self._curv('E'))

    @property
    def pE(self):
        return np.nan_to_num(self._curv('pE'))

    def curvature_grad(self, dN=0.1, skip_prob=0.0):
        """Bending-energy gradient along vertex normals (pyx:349-496)."""
        return self._curv('dEdN')

    # ------------------------------------------------------------------
    # optimizer diagnostics (pyx:1563-1634)

    def _diag(self):
        if self._last_diag is None:
            raise RuntimeError('no solver diagnostics yet - run '
                               'shrink_wrap first')
        return self._last_diag

    def _S_col(self, i):
        V = self.vertices.shape[0]
        S = self._diag().S.cpu().numpy()
        if i >= S.shape[-1]:
            return np.zeros((V, 3), np.float32)
        if S.shape[0] < V:
            # topology changed since the last CG block (e.g. trailing
            # remesh); pad the stale diagnostic
            out = np.zeros((V, 3), np.float32)
            out[:S.shape[0]] = S[:, :, i]
            return out
        return S[:V, :, i]

    @property
    def S0(self):
        return self._S_col(0)

    @property
    def S1(self):
        return self._S_col(1)

    @property
    def S2(self):
        return self._S_col(2)

    @property
    def S3(self):
        return self._S_col(3)

    @property
    def point_dis(self):
        s0 = self.S0
        return np.sqrt((s0 * s0).sum(1))

    @property
    def point_influence(self):
        """|A^T 1| per vertex: the last CG block's value while it covers
        the mesh, else recomputed from the cached point cloud."""
        V = self.vertices.shape[0]
        if self._last_diag is not None:
            pi = self._last_diag.point_influence.cpu().numpy()
            if pi.shape[0] >= V:
                return pi[:V]
        if self._points is None:
            raise RuntimeError('no point cloud - run shrink_wrap first')
        return self._vertex_ah_norm(
            np.ones((self._points.shape[0], 3), np.float32))

    @property
    def rms_point_sc(self):
        """|A^T(|res| replicated)| per vertex (pyx:1611-1623)."""
        res = self._diag().res.cpu().numpy()[:self._points.shape[0]]
        rn = np.sqrt((res * res).sum(1))[:, None] * np.ones(3)[None, :]
        return self._vertex_ah_norm(rn.astype(np.float32))

    def _vertex_ah_norm(self, rows):
        """|A^T rows| per vertex: the (N, 3) per-point ``rows`` of the
        cached cloud spread onto the current mesh's vertices by the
        correspondence weights."""
        ma = self._padded_meshdata()
        pts = torch.from_numpy(
            np.ascontiguousarray(self._points, np.float32)).to(self.device)
        _, fi, _ = self._nearest_for_diagnostics(ma, pts)
        v_idx, w = _corr.correspondence_weights(ma.positions, ma.faces,
                                                pts, fi)
        out = _corr.ah_apply(torch.from_numpy(rows).to(self.device), v_idx,
                             w, ma.positions.shape[0]).cpu().numpy()
        out = out[:self.vertices.shape[0]]
        return np.sqrt((out * out).sum(1))

    def _nearest_for_diagnostics(self, ma, pts):
        """Nearest face of every point and the face centres, by the
        windowed search (in the points' own order) when brute force
        would be too large."""
        centers = ma.positions[ma.faces.long()].mean(1)
        N, Fp = pts.shape[0], ma.faces.shape[0]
        if N * Fp > 2e9:
            order = torch.from_numpy(fit_point_order(pts.cpu().numpy())
                                     ).to(pts.device)
            with tracing.span(self, 'search', method='windowed',
                              n_points=N, n_faces=Fp,
                              route=_corr.search_route('windowed',
                                                       pts.device)):
                d, fi = _corr.nearest_face_windowed(pts[order], centers,
                                                    ma.f_mask)
            inv = torch.empty_like(order)
            inv[order] = torch.arange(N, device=pts.device)
            return d[inv], fi[inv], centers
        with tracing.span(self, 'search', method='brute', n_points=N,
                          n_faces=Fp,
                          route=_corr.search_route('brute', pts.device)):
            d, fi = _corr.nearest_face_bruteforce(
                pts, centers, ma.f_mask, face_chunk=self.face_chunk)
        return d, fi, centers

    # ------------------------------------------------------------------
    # remesh and boundary cleanup

    def remesh(self, n=5, target_edge_length=-1.0, l=0.5, n_relax=10):
        veto = (float(self.remesh_collapse_veto_cos)
                if self.remesh_collapse_veto else None)
        _remesh.remesh(self, n=n, target_edge_length=target_edge_length,
                       l=l, n_relax=n_relax, collapse_veto_cos=veto)
        self._initialize_curvature_vectors()

    # ------------------------------------------------------------------
    # topology surgery: necks, holes, Delaunay remesh

    def _separator_neck_vertices(self, K, t_cand, t_median,
                                 constriction=0.9,
                                 min_piece=16, max_comp_frac=0.05):
        """Negative-K neck vertices by separation: candidates (K <
        ``t_cand``) are grouped into connected patches, and a patch is
        a neck when it borders >= 2 sizable components of the rest of
        the surface (removing it disconnects the mesh), its median K
        clears ``t_median`` (a waist is negatively curved around its
        whole ring; a chain of noise saddles hugs the threshold) and it
        constricts: its ring radius over the adjacent surface's radius
        on both sides is below ``constriction``.  ``max_comp_frac``
        rejects percolating candidate networks."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components

        V = self.vertices.shape[0]
        cand = K < t_cand
        n_cand = int(cand.sum())
        if n_cand == 0 or n_cand == V:
            return np.zeros(0, np.int64)
        he = self.halfedges
        ok = (he.src >= 0) & (he.vertex >= 0)
        src = he.src[ok].astype(np.int64)
        dst = he.vertex[ok].astype(np.int64)

        def comps(edge_mask):
            g = sp.coo_matrix(
                (np.ones(int(edge_mask.sum()), np.int8),
                 (src[edge_mask], dst[edge_mask])), shape=(V, V))
            return connected_components(g, directed=False)

        # components of the surface minus the candidates, and of the
        # candidate-induced subgraph
        _, lab_rest = comps(~cand[src] & ~cand[dst])
        n_k, lab_cand = comps(cand[src] & cand[dst])

        rest_sizes = np.bincount(lab_rest[~cand], minlength=V)
        cand_sizes = np.bincount(lab_cand[cand], minlength=n_k)

        # border edges candidate -> rest: distinct sizable rest
        # components adjacent to each candidate patch
        border = cand[src] & ~cand[dst]
        bk = lab_cand[src[border]]
        br = lab_rest[dst[border]]
        sizable = rest_sizes[br] >= min_piece
        pairs = np.unique(bk[sizable].astype(np.int64) * V
                          + br[sizable])
        touch_counts = np.bincount((pairs // V).astype(np.int64),
                                   minlength=n_k)

        size_cap = max(512, int(max_comp_frac * V))
        sep = (touch_counts >= 2) & (cand_sizes <= size_cap)
        if not sep.any():
            return np.zeros(0, np.int64)
        adj = {}
        for k_l, r_l in zip(bk[sizable], br[sizable]):
            adj.setdefault(int(k_l), set()).add(int(r_l))

        def _constriction_ratio(pmask, sid):
            """Ring radius of the patch over the radius of each adjacent
            surface piece near it; axis = the patch's least-variance
            direction (the ring plane's normal).  The worse side counts;
            with fewer than two measurable sides, inf."""
            P = self.vertices[pmask]
            c = P.mean(0)
            D = P - c
            try:
                _, _, vt = np.linalg.svd(D, full_matrices=False)
            except np.linalg.LinAlgError:
                return np.inf
            axis = vt[-1]
            ax = D @ axis
            r_patch = float(np.linalg.norm(
                D - ax[:, None] * axis[None], axis=1).mean())
            if not np.isfinite(r_patch) or r_patch <= 0:
                return np.inf
            ratios = []
            for r_l in adj.get(sid, ()):
                Q = self.vertices[~cand & (lab_rest == r_l)] - c
                qax = Q @ axis
                band = np.abs(qax) < 3.0 * r_patch
                if band.sum() < 8:
                    continue
                Qb = Q[band]
                r_side = float(np.linalg.norm(
                    Qb - (Qb @ axis)[:, None] * axis[None],
                    axis=1).mean())
                if r_side > 0:
                    ratios.append(r_patch / r_side)
            return max(ratios) if len(ratios) >= 2 else np.inf

        keep = []
        for sid in np.flatnonzero(sep):
            pmask = cand & (lab_cand == sid)
            kk = K[pmask]
            med_ok = len(kk) and float(np.median(kk)) < t_median
            ratio = _constriction_ratio(pmask, int(sid)) if med_ok \
                else np.inf
            ok = med_ok and ratio < constriction
            logger.debug('separator patch %d: %d verts, medK %.2e, '
                         'touches %d, constriction %.2f -> %s', sid,
                         int(pmask.sum()), float(np.median(kk)),
                         int(touch_counts[sid]), ratio,
                         'cut' if ok else 'reject')
            if ok:
                keep.append(sid)
        if not keep:
            return np.zeros(0, np.int64)
        sel = np.zeros(n_k, bool)
        sel[np.asarray(keep)] = True
        return np.flatnonzero(cand & sel[lab_cand])

    def remove_necks(self, neck_curvature_threshold_low=-1e-4,
                     neck_curvature_threshold_high=1e-2,
                     defer_remesh=False):
        """Sever necks flagged by extreme Gaussian curvature
        (pyx:1201-1219): delete the flagged vertices, repair the holes,
        remesh (unless ``defer_remesh``: the fit's scheduled remesh
        follows at the same boundary), drop severed inner fragments and
        closed pieces under ``NECK_FRAGMENT_FACES`` faces.

        ``self.neck_detector`` picks the low-side criterion:
        ``'threshold'`` (the reference's: every vertex below the low
        threshold) or ``'separator'`` (:meth:`_separator_neck_vertices`
        at ``self.neck_separator_threshold``).  The high side (spikes)
        is a threshold in both.  When more than a quarter of the
        vertices trip a threshold detector they flag wrinkle noise, not
        necks, and nothing is removed (the reference removes them
        unconditionally).  Returns ``(flagged, removed)`` vertex
        counts."""
        with tracing.span(self, 'curvature'):
            K = self.curvature_gaussian
        V = self.vertices.shape[0]
        if self.neck_detector == 'separator':
            low = self._separator_neck_vertices(
                K, float(self.neck_separator_threshold),
                float(self.neck_separator_median),
                float(self.neck_separator_constriction))
            high = np.flatnonzero(K > neck_curvature_threshold_high)
            n_flagged = len(low) + len(high)
            # separator patches are connectivity-proven and bypass the
            # safety valve; the spike flags keep it
            if len(high) > 0.25 * V:
                high = high[:0]
            verts = np.union1d(low, high)
        else:
            verts = np.flatnonzero((K < neck_curvature_threshold_low)
                                   | (K > neck_curvature_threshold_high))
            n_flagged = len(verts)
            if len(verts) > 0.25 * V:
                logger.warning(
                    'remove_necks: %d/%d vertices exceed the curvature '
                    'thresholds (wrinkle noise, not necks) - skipping; '
                    'widen neck_threshold_low/high for this dataset',
                    len(verts), V)
                return n_flagged, 0
        if len(verts) == 0:
            logger.info('remove_necks[%s]: 0 verts flagged',
                        self.neck_detector)
            return n_flagged, 0
        with tracing.span(self, 'repair') as rec:
            counts = self.repair(remove=verts)
            if rec is not None:
                rec.extra.update(counts)
        if not defer_remesh:
            self.remesh(n_relax=0)
        with tracing.span(self, 'inner'):
            self.remove_inner_surfaces()
            # a ring of flagged vertices can cut off a closed piece of a
            # few faces that lies on the surface, not inside it; the JAX
            # package keeps such a piece (its repair drops only pieces
            # under 8 faces)
            self.remove_degenerate_components(
                min_faces=NECK_FRAGMENT_FACES)
        logger.info('remove_necks[%s]: %d verts removed',
                    self.neck_detector, len(verts))
        return n_flagged, int(len(verts))

    def punch_holes(self, pts, eps=10.0):
        """Fenestrate the mesh between opposing unsupported face pairs
        (pyx:1163-1199); see ``models.holepunch`` for the passes.
        Returns the number of tunnels punched."""
        from . import holepunch
        n = holepunch.punch_holes(self, pts, eps=eps)
        self._initialize_curvature_vectors()
        return n

    def delaunay_remesh(self, points, eps=1.0):
        """Rebuild the surface from the Delaunay outer hull of the
        current vertices (pyx:612-641)."""
        import scipy.spatial
        from ..eval import delaunay_utils
        v = self.vertices.astype(np.float64)
        d = scipy.spatial.Delaunay(v)
        tri = delaunay_utils.orient_simps(d, v)
        ext_inds = delaunay_utils.greedy_ext_simps(tri, self)
        simps = delaunay_utils.del_simps(tri, ext_inds)
        faces = delaunay_utils.surf_from_delaunay(simps)
        old_v, idxs = np.unique(faces.ravel(), return_inverse=True)
        reindexed = np.arange(len(old_v))[idxs].reshape(faces.shape)
        self.set_topology(v[old_v], reindexed.astype(np.int32))
        self._initialize_curvature_vectors()

    def remove_extra_short_edges(self, threshold=0.05, defer_remesh=False):
        """Remove vertices on pathologically short edges that topology
        prevented collapsing (pyx:1221-1237), rolled back when the
        removal would disconnect the surface.  ``defer_remesh`` skips
        the internal remesh when the scheduled remesh follows."""
        he = self.halfedges
        el = he.length
        if el.size == 0:
            return
        short = el < threshold * np.median(el)
        verts = np.unique(he.vertex[short])
        if len(verts) == 0:
            return
        with tracing.span(self, 'repair') as rec:
            # a hygiene pass must never raise the component count:
            # snapshot and roll back when it does (or when it empties
            # the mesh)
            snap_v = self.vertices.copy()
            snap_f = self.faces.copy()
            n_before = self.connected_components()[1]
            counts = self.repair(remove=verts)
            if rec is not None:
                rec.extra.update(counts)
        if not defer_remesh:
            self.remesh(n_relax=0)
        with tracing.span(self, 'inner'):
            self.remove_inner_surfaces()
            n_after = self.connected_components()[1]
        if n_after > n_before or (n_after == 0 and n_before > 0):
            self.set_topology(snap_v, snap_f)
            self._initialize_curvature_vectors()
            logger.info('short_edges: rolled back (%d verts - removal '
                        'would disconnect the surface)', len(verts))
            return
        logger.info('short_edges: %d verts removed', len(verts))

    # ------------------------------------------------------------------
    # the fit

    def opt_conjugate_gradient(self, points, sigma, max_iter=10,
                               step_size=1.0, weights=None, **kwargs):
        """Outer fit loop (pyx:1427-1560): CG blocks on the device
        that run to the next boundary, and between blocks on the host
        hole punching every ``delaunay_remesh_frequency`` iterations and,
        every ``remesh_frequency``, neck removal (after
        ``neck_first_iter``), short-edge cleanup and a remesh on a
        linear edge-length schedule."""
        r = (self.remesh_frequency != 0) \
            and (self.remesh_frequency <= max_iter)
        dr = ((self.delaunay_remesh_frequency != 0)
              and (self.delaunay_remesh_frequency <= max_iter))
        dmesh = sharding.mesh_for(getattr(self, 'device_mesh', None),
                                  self.device)
        if dmesh is not None:
            self.device_mesh = dmesh
            if dmesh.devices[0].type != self.device.type:
                raise ValueError(f'device_mesh runs on {dmesh.devices[0]} '
                                 f'but the model is on {self.device}')
            if not sharding.in_group(dmesh):
                # rank 0 is this process; every rank runs this fit on
                # its slice of the cloud
                kw = dict(kwargs, max_iter=max_iter, step_size=step_size,
                          weights=weights)
                return sharding.run_ranks(
                    dmesh, lambda: self.opt_conjugate_gradient(
                        points, sigma, **kw),
                    sharding.fit_rank, (type(self),
                                        sharding.host_state(self),
                                        points, sigma, kw))
        if self.trace is None:
            # a sharded fit's spawned rank rebuilds its model
            # without one
            self.trace = FitTrace()
        trace = self.trace
        trace.j = 0
        # the set-up before the loop
        with trace.span('prep'):
            rank = None if dmesh is None else sharding.spmd_rank(dmesh)
            cap_mode = self.capacity_mode
            if cap_mode not in ('final', 'two', 'bucketed'):
                raise ValueError(f'unknown capacity_mode {cap_mode!r}')
            # the edge-length schedule's step: with both cadences on, the
            # reference's block length gcd(remesh, punch) (pyx:1430-1441)
            if r and dr:
                rf = math.gcd(self.remesh_frequency,
                              self.delaunay_remesh_frequency)
            elif r:
                rf = self.remesh_frequency
            elif dr:
                rf = self.delaunay_remesh_frequency
            else:
                rf = max_iter

            if r:
                initial_length = self._mean_edge_length
                if kwargs.get('minimum_edge_length', -1) < 0:
                    final_length = float(np.clip(np.min(sigma) / 2.5,
                                                 1.0, 50.0))
                else:
                    final_length = kwargs.get('minimum_edge_length')
                m = (final_length - initial_length) \
                    / (rf * np.ceil(max_iter / rf))

            points = np.ascontiguousarray(points, dtype=np.float32)
            N = points.shape[0]
            # sigma -> per-point inverse errors (pyx:1460-1473)
            if np.isscalar(sigma):
                sigma_inv = np.full((N, 3), 1.0 / float(sigma), np.float32)
            else:
                sigma = np.asarray(sigma)
                if sigma.ndim == 1 and sigma.shape[0] == N:
                    sigma_inv = (1.0 / sigma)[:, None].repeat(3, 1)
                elif sigma.ndim == 2 and sigma.shape == (N, 3):
                    sigma_inv = 1.0 / sigma
                else:
                    raise ValueError(
                        f"Sigma must be scalar, ({N},) or ({N},3); got "
                        f"{np.shape(sigma)}")
                sigma_inv = sigma_inv.astype(np.float32)

            w = sigma_inv if weights is None else \
                np.asarray(weights, dtype=np.float32).reshape(N, 3)
            res_weights = (w / w.mean()).astype(np.float32)

            lam0 = float(step_size * self.kc / 2.0)
            use_shrink = self.shrink_weight > 0
            shrink_lam = float(self.shrink_weight)
            n_iter = int(min(max_iter, self.truncate_at))

            method = self.corr_method
            if method != 'auto':
                method = CORR_ALIASES.get(method, method)
            if method == 'auto':
                # windowed (K1 + K2) once brute force would cost more than
                # 2e9 point-face pairs; which of a kernel or its plain
                # version runs is decided by each wrapper from the tensors'
                # device (CUDA -> kernel, CPU -> plain)
                method = 'windowed' if N * 2 * self.vertices.shape[0] > 2e9 \
                    else 'brute'
            self._last_corr_method = method
            # face-side normal equations need strictly positive weights on
            # every coordinate
            uniform_weights = bool(np.all(res_weights > 0))

            # capacity policy 'final': one capacity for the whole fit,
            # predicted from the last executed remesh boundary's clamped
            # target length (pyx:1541-1546 leaves the schedule unclamped);
            # 'two' starts at a mid rung and keeps the final one in
            # _cap_rungs; 'bucketed' sizes each block in the loop
            self._cap_rungs = []
            if r and cap_mode in ('final', 'two'):
                last_remesh_iter = (n_iter // self.remesh_frequency) \
                    * self.remesh_frequency
                pred_final_len = max(float(np.clip(
                    initial_length + m * (last_remesh_iter + 1),
                    min(initial_length, final_length),
                    max(initial_length, final_length))), 1e-3)
                # F = 1.15 area / equilateral-triangle-area(l), with 1.15
                # headroom on top (the seed is an outer wrap, so its area
                # bounds the final area)
                pred_faces = 1.15 * self.area() / (np.sqrt(3.0) / 4.0
                                                   * pred_final_len ** 2)
                pred_faces = max(pred_faces, self.faces.shape[0])
                f_cap = meshdata.round_up_bucket(int(1.15 * pred_faces),
                                                 self.pad_quantum)
                v_cap = meshdata.round_up_bucket(
                    int(1.15 * pred_faces / 2) + 8, self.pad_quantum)
                if cap_mode == 'two':
                    v_mid = meshdata.round_up_bucket(
                        max(v_cap // 2, self.vertices.shape[0] + 8),
                        self.pad_quantum)
                    f_mid = meshdata.round_up_bucket(
                        max(2 * v_mid - 4, self.faces.shape[0]),
                        self.pad_quantum)
                    if v_mid < v_cap and f_mid < f_cap:
                        self._cap_rungs = [(v_cap, f_cap)]
                        v_cap, f_cap = v_mid, f_mid
                    # else the seed is already past half the final size:
                    # one rung, as 'final'
            else:
                v_cap = f_cap = None
            self._final_caps_pred = (v_cap, f_cap) if v_cap is not None \
                else None

            # block length: up to the next boundary of either cadence
            ni_static = n_iter
            if r:
                ni_static = min(ni_static, self.remesh_frequency)
            if dr:
                ni_static = min(ni_static, self.delaunay_remesh_frequency)

            # neck removal reads K at every remesh boundary: from the native
            # host kernel, or (use_native_neck_k False) from the CG block on
            # the device
            want_K = bool(r and self.neck_first_iter > 0
                          and not self.use_native_neck_k)

            if method in ('windowed', 'blocked'):
                with trace.span('order'):
                    order = fit_point_order(points)
                    points = np.ascontiguousarray(points[order])
                    sigma_inv = sigma_inv[order]
                    res_weights = res_weights[order]
                    # diagnostics follow this order
                    self._points = points

            with trace.span('upload'):
                if dmesh is not None:
                    # this rank's slice of whole 256-point blocks
                    dev = dmesh.devices[rank]
                    pts_t, sig_t, w_t, pmask = sharding.shard_points(
                        dmesh, rank, points, sigma_inv, res_weights)
                else:
                    dev = self.device
                    pts_t = torch.from_numpy(points).to(dev)
                    sig_t = torch.from_numpy(
                        np.ascontiguousarray(sigma_inv)).to(dev)
                    w_t = torch.from_numpy(
                        np.ascontiguousarray(res_weights)).to(dev)
                    pmask = torch.ones(N, dtype=torch.bool, device=dev)

        j = 0
        topo_dirty = True
        state = None
        f_dev = None
        while j < n_iter:
            n_it = n_iter - j
            if r:
                n_it = min(n_it, self.remesh_frequency
                           - (j % self.remesh_frequency))
            if dr:
                n_it = min(n_it, self.delaunay_remesh_frequency
                           - (j % self.delaunay_remesh_frequency))
            n_it = int(n_it)

            with trace.span('cg_block') as blk:
                # host seconds of the topology rebuild, by step
                prep = {}
                if topo_dirty or state is None:
                    with trace.span('sort') as sp:
                        # index locality for the device gathers and
                        # scatters
                        self.spatial_sort()
                    prep['sort_s'] = sp.wall_time
                    if r and cap_mode == 'bucketed':
                        # 15% headroom inside the bucket, monotone
                        vb, fb = meshdata.fit_buckets(
                            self.vertices.shape[0], self.faces.shape[0],
                            self.pad_quantum)
                        v_cap = max(v_cap or 0, vb)
                        f_cap = max(f_cap or 0, fb)
                    elif (r and cap_mode == 'two' and self._cap_rungs
                            and (self.vertices.shape[0] > v_cap
                                 or self.faces.shape[0] > f_cap)):
                        # the mesh outgrew the mid rung: advance to the
                        # final one
                        vb, fb = self._cap_rungs.pop(0)
                        v_cap = max(v_cap, vb)
                        f_cap = max(f_cap, fb)
                    if v_cap is not None and (
                            self.vertices.shape[0] > v_cap
                            or self.faces.shape[0] > f_cap):
                        # remesh overshot the prediction; grow the
                        # capacity
                        v_cap = meshdata.round_up_bucket(
                            int(1.3 * self.vertices.shape[0]),
                            self.pad_quantum)
                        f_cap = meshdata.round_up_bucket(
                            int(1.3 * self.faces.shape[0]),
                            self.pad_quantum)
                    # spatial_sort already Hilbert-ordered the faces
                    with trace.span('pad') as sp:
                        ma = meshdata.from_mesh(
                            self, v_cap=v_cap, f_cap=f_cap,
                            quantum=self.pad_quantum, hilbert_faces=False,
                            device=dev)
                    prep['pad_s'] = sp.wall_time
                    with trace.span('tables') as sp:
                        tables = None
                        if ma.positions.shape[0] > self.ring_gather_min_verts:
                            tables = meshdata.gather_tables(ma)
                    prep['tables_s'] = sp.wall_time
                    state = (ma, tables)
                    positions = ma.positions
                else:
                    ma, tables = state
                    positions = f_dev

                # the block: from its call to its positions on the host
                with trace.span('block') as call:
                    f_new, diag = block_call(
                        positions, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
                        pts_t, sig_t, w_t, pmask, lam0, shrink_lam,
                        num_iters=ni_static, active_iters=n_it,
                        use_shrink=use_shrink,
                        face_chunk=self.face_chunk, corr_method=method,
                        cell_size=(float(2.0 * self._mean_edge_length)
                                   if method == 'grid' else 1.0),
                        face_nbrs=ma.face_nbrs, tables=tables,
                        nbr_f=ma.nbr_f if want_K else None,
                        want_curv_K=want_K,
                        face_hcgc=(method == 'windowed'
                                   and tables is not None
                                   and ma.positions.shape[0]
                                   > meshdata.HCGC_MIN_VP
                                   and uniform_weights),
                        spmd_mesh=dmesh, trace=trace)
                    if dmesh is not None:
                        # every rank goes on from rank 0's positions and K
                        sharding.broadcast_from_rank0(f_new, diag.K)
                        if j + n_it >= n_iter:
                            diag = sharding.gather_diagnostics(diag, N)
                    f_dev = f_new
                    topo_dirty = False
                    self._last_diag = diag
                    V = self.vertices.shape[0]
                    new_pos = f_new[:V].cpu().numpy()
                # the host state after the block, and this record
                with trace.span('update'):
                    if not np.isfinite(new_pos).all():
                        # counterpart of the reference's NaN asserts
                        # (mesh_conj_grad.py:548,580,613)
                        raise FloatingPointError(
                            'non-finite vertex positions after CG block '
                            f'at iteration {j + n_it}; check sigma/weights '
                            'inputs')
                    self.set_positions(new_pos)
                    self._initialize_curvature_vectors()
                    if diag.K is not None:
                        # seed the curvature cache with the block's K (the
                        # same positions and tables); other fields
                        # repopulate on demand
                        self._curv_state = {'_dev': _curv.CurvatureState(
                            k_0=None, k_1=None, e_0=None, e_1=None, H=None,
                            K=diag.K, dH=None, dK=None, E=None, pE=None,
                            dE_neighbors=None, dEdN=None)}
                    j += n_it
                    trace.j = j
                    # block_s: the block's call to here, which overlaps
                    # this span
                    blk.extra.update(
                        n_iters=n_it, v_cap=int(positions.shape[0]),
                        block_s=(trace.now_ns() - call.start_ns) / 1e9,
                        shrink=use_shrink,
                        directions=int(diag.S.shape[-1]), **prep)
                    blk.observe(self, diag)
            logger.info('cg_block done j=%d/%d (%.1fs, V=%d, cap=%s)',
                        j, n_iter, blk.wall_time,
                        self.vertices.shape[0], v_cap)

            # at a shared boundary the punch comes first, then the
            # necks, the short edges and the remesh (pyx:1534-1546).
            # The punch gets the fit's one points array at every
            # boundary: its kNN field is cached on that array.
            if dr and (j % self.delaunay_remesh_frequency) == 0:
                with trace.span('punch_holes') as rec:
                    n_punched = self.punch_holes(points, self.delaunay_eps)
                    rec.extra['n_punched'] = n_punched
                    rec.observe(self)
                if n_punched:
                    topo_dirty = True

            if r and (j % self.remesh_frequency) == 0:
                defer = bool(self.defer_boundary_remesh)
                if self.neck_first_iter > 0 and j > self.neck_first_iter:
                    with trace.span('remove_necks') as rec:
                        flagged, removed = self.remove_necks(
                            self.neck_threshold_low,
                            self.neck_threshold_high, defer_remesh=defer)
                        rec.extra.update(necks_flagged=flagged,
                                         necks_removed=removed)
                        rec.observe(self)
                with trace.span('short_edges') as rec:
                    self.remove_extra_short_edges(defer_remesh=defer)
                    rec.observe(self)
                # clamped to the schedule's endpoints: at j = n_iter
                # divisible by rf the unclamped line overshoots
                # final_length (pyx:1541-1546)
                target_length = float(np.clip(
                    initial_length + m * (j + 1),
                    min(initial_length, final_length),
                    max(initial_length, final_length)))
                with trace.span('remesh',
                                target_length=target_length) as rec:
                    self.remesh(5, target_length, 0.5, n_relax=0)
                    rec.observe(self)
                topo_dirty = True
                logger.info(
                    'Shrinkwrapping iteration %d of %d - Remesh: target '
                    'mean length: %.2f resulting: %.2f (V=%d)',
                    j, n_iter, target_length, self._mean_edge_length,
                    self.vertices.shape[0])
            if dmesh is not None:
                with trace.span('in_step') as rec:
                    sharding.check_in_step(dmesh, self.vertices, self.faces,
                                           where=f' after iteration {j}')
                    rec.observe(self)

        logger.info('Shrinkwrapping complete in %d iterations (%s)',
                    j, self.trace.summary())

    def shrink_wrap(self, points=None, sigma=None,
                    method='conjugate_gradient', max_iter=None, **kwargs):
        """Main entry (pyx:1641-1669); caches points/sigma so repeated
        calls continue the fit."""
        if method not in DESCENT_METHODS:
            logger.warning('Unknown descent method %r; using %s', method,
                           DEFAULT_DESCENT_METHOD)
            method = DEFAULT_DESCENT_METHOD
        if max_iter is None:
            max_iter = self.max_iter
        if points is None:
            points = self._points
        if sigma is None:
            sigma = self._sigma
        self._points = np.asarray(points)
        self._sigma = sigma
        opts = dict(points=points, sigma=sigma, max_iter=max_iter,
                    step_size=self.step_size, **kwargs)
        return getattr(self, 'opt_{}'.format(method))(**opts)

    def opt_skeleton(self, points, sigma, max_iter=10, step_size=None,
                     **kwargs):
        """Skeletonize through a SkeletonMesh view of this mesh and write
        the collapsed topology back (``shrink_wrap(method='skeleton')``
        on a plain MembraneMesh, as SkeletonMesh.shrink_wrap does)."""
        from .skeleton_mesh import SkeletonMesh
        sk = SkeletonMesh(self.vertices.copy(), self.faces.copy(),
                          device=self.device)
        sk.opt_skeleton(points=points, sigma=sigma, max_iter=max_iter,
                        **kwargs)
        self.set_topology(sk.vertices, sk.faces)
        self._initialize_curvature_vectors()
        return self

    def residual_histogram(self, points=None, sigma=None, bins=None):
        """Signed distance-to-surface histogram with the chi-distribution
        overlay (util.py:49-76).  Returns (counts, bin edges, predicted
        density); plotting is left to the caller."""
        if points is None:
            points = self._points
        if sigma is None:
            sigma = self._sigma
        d = self.distance_to_surface(points)
        if bins is None:
            bins = np.linspace(-100, 100, 500)
        counts, edges = np.histogram(d, bins, density=True)
        try:
            from scipy import stats
            me = float(np.median(sigma))
            x = 0.5 * (edges[:-1] + edges[1:])
            pred = 0.5 * stats.chi(3).pdf(np.abs(x) / me) / me
        except Exception:
            pred = None
        return counts, edges, pred

    def distance_to_surface(self, points):
        """Signed distance of points to the mesh (negative inside), by
        the nearest face's plane."""
        ma = self._padded_meshdata()
        pts = torch.from_numpy(
            np.ascontiguousarray(points, np.float32)).to(self.device)
        dmean, fi, centers = self._nearest_for_diagnostics(ma, pts)
        fn, _ = _norm.face_geometry(ma.positions, ma.faces, ma.f_mask)
        fi_l = fi.long()
        n = fn[fi_l].cpu().numpy()
        c = centers[fi_l].cpu().numpy()
        signed = ((np.asarray(points) - c) * n).sum(1)
        return np.sign(signed) * dmean.cpu().numpy()
