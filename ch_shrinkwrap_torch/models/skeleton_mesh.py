"""SkeletonMesh — mean-curvature-flow skeletonization.

Rebuild of the reference ch_shrinkwrap/_skeleton_mesh.pyx (SkeletonMesh
:24, opt_skeleton :673-725) and the SkeletonConjGrad solver
(the reference ch_shrinkwrap/conj_grad.py:1045-1231, after
Tagliasacchi et al., "Mean Curvature Skeletons", CGF 2012):

minimize  || Lw f ||^2 + lam_med^2 || f - nearest_negative_pole(f) ||^2

where ``Lw`` is the umbrella Laplacian scaled by 1/sqrt(sum of squared
one-ring edge lengths) (the reference's ``c_shrinkwrap_lw_func``,
conj_grad_utils.c:370-487) and the medial prior attracts each vertex to
its nearest negative Voronoi pole (Amenta-Bern), computed once from the
initial surface.

The working set during skeletonization is a few thousand vertices with
a remesh every iteration (rf = 1, _skeleton_mesh.pyx:676), so the
solver runs host-side in vectorized numpy: device round-trips per
iteration would dominate (measured: a 2.5k-vertex iteration is ~3 ms
of numpy; one device dispatch alone costs more).  The subspace solve
offers both linearizations of the nonlinear medial term
(``medial_linearization=``): ``'reference'`` passes search directions
through the nearest-pole map exactly as the reference subsearch does
(conj_grad.py:183-229 + Mfunc), and ``'identity'`` (default) uses the
Gauss-Newton Jacobian — measured decisive on a torus (perfect R=40
ring vs a stalled half-contraction; see opt_skeleton comment).

Remeshing: ``remesh_method='isotropic'`` (default) matches the
reference's SHIPPED behavior — its opt_skeleton calls the generic
``remesh`` with the skeleton machinery commented out
(_skeleton_mesh.pyx:716-719); ``remesh_method='skeleton'`` enables the
rebuilt skeleton remesher (guarded collapse + angle-driven projection
split, _skeleton_mesh.pyx:29-614 -> batch passes).
"""

from __future__ import annotations

import logging

import numpy as np

from .membrane_mesh import MembraneMesh

logger = logging.getLogger(__name__)


def _lw_apply(f, nbrs, ref_pos):
    """Edge-weighted umbrella Laplacian: sum_n (f_n - f_i) / sqrt(w_i)
    with w_i = sum of squared one-ring edge lengths on ``ref_pos``."""
    mask = nbrs >= 0
    safe = np.clip(nbrs, 0, None)
    edge = (ref_pos[safe] - ref_pos[:, None, :]) * mask[..., None]
    w = (edge ** 2).sum(axis=(1, 2))
    scale = np.where(w > 0, 1.0 / np.sqrt(np.maximum(w, 1e-30)), 0.0)
    diff = (f[safe] - f[:, None, :]) * mask[..., None]
    return diff.sum(1) * scale[:, None]


def _lw_adjoint(r, nbrs, ref_pos):
    """Adjoint of _lw_apply (scatter form of c_shrinkwrap_lhw_func)."""
    mask = nbrs >= 0
    safe = np.clip(nbrs, 0, None)
    edge = (ref_pos[safe] - ref_pos[:, None, :]) * mask[..., None]
    w = (edge ** 2).sum(axis=(1, 2))
    scale = np.where(w > 0, 1.0 / np.sqrt(np.maximum(w, 1e-30)), 0.0)
    rs = r * scale[:, None]
    out = -rs * mask.sum(1)[:, None]
    np.add.at(out, safe.ravel(),
              np.repeat(rs, nbrs.shape[1], axis=0)
              * mask.ravel()[:, None])
    return out


class SkeletonMesh(MembraneMesh):
    """Mesh that collapses onto its medial skeleton under MCF."""

    def __init__(self, vertices=None, faces=None, mesh=None, **kwargs):
        MembraneMesh.__init__(self, vertices, faces, mesh, **kwargs)
        self._neg_poles = None

    def _compute_negative_poles(self):
        import scipy.spatial
        from ..eval.delaunay_utils import voronoi_poles, \
            clean_neg_voronoi_poles

        if self.volume() < 0:
            # inward-wound input: negative poles would land OUTSIDE,
            # the inside-test in clean_neg_voronoi_poles would invert,
            # and the medial attraction would collapse to garbage —
            # repair the winding (orientation carries no semantics)
            logger.warning('mesh is inward-wound (volume < 0); '
                           'flipping face winding')
            self.set_topology(self.vertices, self.faces[:, ::-1].copy())
        v = self.vertices.astype(np.float64)
        vor = scipy.spatial.Voronoi(v)
        _, pn = voronoi_poles(vor, self.vertex_normals)
        poles = vor.vertices[pn[pn != -1]]
        poles = clean_neg_voronoi_poles(self, poles)
        if len(poles) == 0:
            poles = v.mean(0)[None, :]
        self._neg_poles = poles
        import scipy.spatial as sp
        self._pole_tree = sp.cKDTree(poles)

    def _medial_map(self, x):
        """Mfunc (conj_grad.py:1160-1184): x - nearest_negative_pole(x).
        Applied to positions AND to search directions (the reference
        passes directions through the same nearest-pole query)."""
        _, idx = self._pole_tree.query(x, k=1, workers=-1)
        idx = np.clip(idx, 0, len(self._neg_poles) - 1)
        return x - self._neg_poles[idx]

    def skeleton_remesh(self, target_edge_length=-1.0,
                        max_triangle_angle=1.9198622):
        """Skeleton-specific remesh (skeleton_remesh,
        _skeleton_mesh.pyx:637-671): guarded collapse of short edges
        followed by the angle-driven projection split."""
        from ..mesh import remesh as _rm
        v = self.vertices
        f = self.faces
        if target_edge_length < 0:
            lo = v.min(0)
            hi = v.max(0)
            collapse_threshold = 0.002 * float(np.linalg.norm(hi - lo))
        else:
            collapse_threshold = float(target_edge_length)
        v, f, n_col = _rm.collapse_pass(v, f, collapse_threshold)
        v, f = _rm.compact(v, f)
        v, f, n_spl = _rm.skeleton_split_pass(
            v, f, max_triangle_angle=max_triangle_angle)
        logger.info('skeleton_remesh: %d collapses, %d splits', n_col,
                    n_spl)
        self.set_topology(v, f)
        self._initialize_curvature_vectors()
        return 1

    def opt_skeleton(self, points=None, sigma=None, max_iter=10, lam=None,
                     target_edge_length=-1.0, remesh_method='isotropic',
                     max_triangle_angle=110.0,
                     medial_linearization='identity', **kwargs):
        """Mean-curvature-flow skeleton fit loop (opt_skeleton,
        _skeleton_mesh.pyx:673-725): one CG iteration per remesh."""
        lam = list(lam) if lam is not None else [40.0]
        area_variation_factor = kwargs.get('area_variation_factor', 1e-4)

        original_area = self.area()
        last_area = original_area

        # Voronoi poles from the INITIAL surface (conj_grad.py:1196-1202)
        self._compute_negative_poles()

        prev_v = self.vertices.copy()
        prev_f = self.faces.copy()
        for j in range(max_iter):
            pos = self.vertices.astype(np.float64)
            nbrs = self.vertex_neighbors

            # residual of the contraction term (data = zeros)
            Af = _lw_apply(pos, nbrs, pos)
            res = -Af
            S0 = _lw_adjoint(res, nbrs, pos)

            # medial prior: pull toward nearest negative pole
            pref = self._medial_map(pos)
            S1 = -pref

            # subspace solve over [S0, S1] (last_step=False for
            # skeletonization, conj_grad.py:1047-1049).
            # medial_linearization='reference' passes search DIRECTIONS
            # through the nearest-pole map exactly as the reference
            # subsearch does (conj_grad.py:197-200 + Mfunc) — which
            # treats displacement vectors as positions, yielding
            # near-constant LS columns (~ -pole_nearest_origin) that
            # ill-condition H and stall/destabilize the flow on shapes
            # whose poles sit far from the origin (measured: torus).
            # 'identity' (default) linearizes Mfunc about f, whose
            # Jacobian is the identity a.e. — the mathematically
            # consistent Gauss-Newton step, and stable.
            S = [S0, S1]
            AS = [_lw_apply(s, nbrs, pos) for s in S]
            if medial_linearization == 'reference':
                LS = [self._medial_map(s) for s in S]
            else:
                LS = S
            n_s = len(S)
            H = np.zeros((n_s, n_s))
            G = np.zeros(n_s)
            lam2 = lam[0] ** 2
            for a in range(n_s):
                G[a] = (AS[a] * res).sum() - lam2 * (LS[a] * pref).sum()
                for b in range(n_s):
                    H[a, b] = ((AS[a] * AS[b]).sum()
                               + lam2 * (LS[a] * LS[b]).sum())
            H += 1e-12 * np.eye(n_s)
            try:
                c = np.linalg.solve(H, G)
            except np.linalg.LinAlgError:
                break
            new_pos = pos + sum(ci * si for ci, si in zip(c, S))
            self.set_positions(new_pos.astype(np.float32))

            # remesh every iteration (rf = 1)
            if remesh_method == 'skeleton':
                self.skeleton_remesh(
                    target_edge_length,
                    max_triangle_angle=np.pi * max_triangle_angle / 180.0)
            else:
                self.remesh(1, target_edge_length, 0.5, n_relax=0)

            area = self.area()
            area_ratio = abs(last_area - area) / original_area
            logger.info('skeleton iter %d: V=%d area ratio %.5f',
                        j, self.vertices.shape[0], area_ratio)
            if area_ratio < area_variation_factor:
                break
            # Divergence guard (deviation from the reference, which has
            # none and can blow up: MCF on a fully collapsed filament
            # produces near-singular Lw scales and the subspace step
            # explodes — measured 33x area growth on a torus).  MCF
            # area must shrink; growth past the starting area means the
            # flow has gone unstable -> roll back one step and stop.
            if area > min(1.2 * original_area, 2.0 * last_area + 1e-9):
                logger.warning(
                    'skeleton flow diverged at iter %d (area %.3g from '
                    '%.3g); rolling back and stopping', j, area,
                    last_area)
                self.set_topology(prev_v, prev_f)
                self._initialize_curvature_vectors()
                break
            prev_v = self.vertices.copy()
            prev_f = self.faces.copy()
            last_area = area
        return self
