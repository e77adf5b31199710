"""The shrinkwrap conjugate-gradient block on torch tensors.

Counterpart of the JAX package's ``solver/shrinkwrap.py``: an
N-direction subspace minimisation of

    || W (points - A f) ||^2 + lam^2 || f - fdef ||^2

where A is the point->face correspondence operator (rebuilt every
iteration) and fdef the curvature-aware ``_ncc`` prior.  One block runs
``num_iters`` iterations as a Python loop on the tensors' device; the
orthogonality statistic of the search directions (the reference's early
stop, conj_grad.py:151-162) is read back once per iteration and freezes
the block when it triggers.

With ``corr_method='windowed'`` the nearest-face search runs through K1
(``ops.cuda_window``) and the A^T accumulation through K2
(``ops.cuda_scatter``); 'grid' and 'blocked' are the JAX package's
other two approximate searches, in plain torch.  With ``tables``
(``ops.meshdata.gather_tables``) the face-corner, one-ring and
search-direction gathers run through K3
(``ops.cuda_gather``) and the faces -> vertices fold through its fused
gather + masked sum.  On CPU tensors each kernel wrapper runs its
plain PyTorch version.  With ``spmd_mesh`` the block runs as one rank
of a sharded fit (``parallel.sharding``): the point-axis work on the
rank's slice of the cloud, with all-reduced face accumulators and
small reductions.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import correspondence as corr
from ..ops import cuda_scatter
from ..ops import normals as _normals
from ..ops.curvature import curvature_grad
from ..ops.cuda_gather import row_gather, row_group_sum
from ..ops.cuda_scatter import windowed_ah, windowed_ahw2
from ..parallel.sharding import spmd_rank

CORR_METHODS = ('brute', 'grid', 'blocked', 'windowed')
# the JAX package's names for its production path
CORR_ALIASES = {'windowed_pallas': 'windowed', 'auto': 'windowed'}


class SolverDiagnostics(NamedTuple):
    """Per-iteration traces (length num_iters; NaN / 0 once frozen) and
    the last live iteration's state."""
    tests: torch.Tensor            # orthogonality test statistic
    ress: torch.Tensor             # ||res||
    n_done: torch.Tensor           # number of iterations applied
    S: torch.Tensor                # (Vp, 3, s_size) search directions
    res: torch.Tensor              # (N, 3) weighted residuals
    point_influence: torch.Tensor  # (Vp,) |A^T 1| per vertex
    d: torch.Tensor                # (N,) point->face distances
    K: Optional[torch.Tensor] = None
    fi: Optional[torch.Tensor] = None   # (N,) i32 nearest face ids


def _ncc_finish(f, vnormals, point_influence, sum_pos, ms, a_num):
    ms_safe = torch.clamp(ms, min=1.0)
    vc = sum_pos / ms_safe[:, None]
    alpha = a_num / ms_safe
    alpha = alpha * torch.clamp(point_influence ** 2, max=1.0)
    out = vc + alpha[:, None] * vnormals
    return torch.where((ms == 0)[:, None], f, out)


def compute_ncc(f, nbr_v, vnormals, point_influence, v_mask, kmajor=None):
    """The curvature-aware smoothing prior ``_ncc``
    (mesh_conj_grad.py:770-820): neighbour centroid plus an alpha *
    normal offset, alpha from neighbour-normal geometry, gated by the
    squared point influence.

    ``kmajor`` = (ncc_idx, ncc_care, ncc_ov) from ``GatherTables``
    selects the k-major form: one K3 gather of [position, normal] rows
    over the (NCC_K, Vp) neighbour stream, reduced over k with the
    vertex axis contiguous, plus exact overflow terms for neighbour
    slots >= NCC_K.  Without it the plain (Vp, K, 6) form runs."""
    Vp = f.shape[0]
    vm = v_mask.bool()
    fn = torch.cat([f, vnormals], dim=1)                      # (Vp, 6)
    if kmajor is not None:
        idx, care, ov = kmajor
        Kn = care.shape[0]
        g = row_gather(fn, idx).reshape(Kn, Vp, 6)
        mf = (care & vm[None, :]).to(f.dtype)                 # (Kn, Vp)
        pos = g[..., 0:3] * mf[..., None]
        nrm = g[..., 3:6]
        ms = mf.sum(0)
        sum_pos = pos.sum(0)                                  # (Vp, 3)
        if ov is not None:
            sv, su = ov
            ovf = vm[sv].to(f.dtype)
            sum_pos = cuda_scatter.segment_sum_ordered(
                f[su] * ovf[:, None], sv, Vp, init=sum_pos)
            ms = cuda_scatter.segment_sum_ordered(ovf, sv, Vp, init=ms)
        vc = sum_pos / torch.clamp(ms, min=1.0)[:, None]
        t_pos = (pos * nrm).sum(-1)                           # (Kn, Vp)
        t_vc = (vc[None] * nrm).sum(-1)
        ndn = (nrm * vnormals[None]).sum(-1)
        denom = torch.sqrt(2.0 * (torch.clamp(ndn, min=0.0) + 1.0))
        a_num = ((t_pos - t_vc * mf) / denom * mf).sum(0)     # (Vp,)
        if ov is not None:
            n_u = vnormals[su]
            ndn_o = (n_u * vnormals[sv]).sum(-1)
            den_o = torch.sqrt(2.0 * (torch.clamp(ndn_o, min=0.0) + 1.0))
            t_o = ((f[su] - vc[sv]) * n_u).sum(-1) / den_o * ovf
            a_num = cuda_scatter.segment_sum_ordered(t_o, sv, Vp,
                                                     init=a_num)
        return _ncc_finish(f, vnormals, point_influence, sum_pos, ms,
                           a_num)
    nmask = (nbr_v >= 0) & vm[:, None]
    nm = nmask.to(f.dtype)
    vg = fn[nbr_v.long().clamp(0, Vp - 1)]                    # (Vp, K, 6)
    vpos = vg[..., 0:3]
    n_n = vg[..., 3:6]
    ms = nm.sum(-1)
    sum_pos = (vpos * nm[..., None]).sum(1)
    vc = sum_pos / torch.clamp(ms, min=1.0)[:, None]
    c_n = (vpos - vc[:, None, :]) * nm[..., None]
    n_dot_n = (n_n * vnormals[:, None, :]).sum(-1)
    alpha_j = ((c_n * n_n).sum(-1)
               / torch.sqrt(2.0 * (torch.clamp(n_dot_n, min=0.0) + 1.0)))
    a_num = (alpha_j * nm).sum(-1)
    return _ncc_finish(f, vnormals, point_influence, sum_pos, ms, a_num)


def _fold(fused, faces, Vp, tables):
    """faces -> vertices fold of the (3 Fp, C) corner rows: with
    ``tables``, K3's fused gather + masked sum of each vertex's
    incident rows (and the overflow rows added exactly); else
    the ordered segment sum."""
    if tables is None:
        return cuda_scatter.segment_sum_ordered(fused, faces.reshape(-1),
                                                Vp)
    out = row_group_sum(fused, tables.fold_idx, tables.fold_care)
    if tables.fold_ov is not None:
        ov_rows, ov_verts = tables.fold_ov
        out = cuda_scatter.segment_sum_ordered(fused[ov_rows], ov_verts, Vp,
                                               init=out)
    return out


def cg_block(positions, faces, f_mask, v_mask, nbr_v,
             points, sigma_inv, weights, point_mask,
             lam0, shrink_lam=0.0, num_iters=5,
             use_shrink=False, face_chunk=2048, stop_eps=1e-6,
             corr_method='brute', cell_size=1.0, face_nbrs=None,
             polish_iters=0, tables=None, face_hcgc=False,
             active_iters=None, nbr_f=None, want_curv_K=False,
             spmd_mesh=None, trace=None):
    """Run up to ``num_iters`` CG iterations; returns (new_positions,
    SolverDiagnostics).

    positions : (Vp, 3) f32 padded vertex positions
    faces, f_mask, v_mask, nbr_v : padded MeshArrays fields
    points : (N, 3) f32 localizations (``fit_point_order``-sorted for
        the windowed search)
    sigma_inv : (N, 3) f32 inverse localization errors
    weights : (N, 3) f32 residual weights; zero rows drop out of the
        subspace solve
    point_mask : (N,) bool padding mask of the point cloud
    lam0 : regularization weight (= step_size * kc / 2)
    corr_method : 'brute' (exact), 'windowed' (K1 + K2; the JAX names
        'windowed_pallas' and 'auto' mean the same), 'grid' (hash grid
        of cell ``cell_size``) or 'blocked' (per-block candidates)
    tables : optional ``GatherTables`` routing the gathers through K3
    face_hcgc : contract the subspace normal equations face-side (needs
        'windowed' and strictly positive weights on every coordinate)
    active_iters : iterations beyond it are skipped (frozen)
    use_shrink : add the shrink prior (weight ``shrink_lam``) as a
        fourth search direction, between the ncc prior and the
        classic-CG memory direction
    want_curv_K : with ``nbr_f``, return the Gaussian curvature at the
        final positions as ``diag.K``
    spmd_mesh : a ``parallel.sharding.DeviceMesh`` inside its process
        group: ``points``, ``sigma_inv``, ``weights`` and ``point_mask``
        are this rank's ``shard_points`` slice (whole 256-point blocks);
        the face accumulators (and W2), the point-side normal equations
        and the residual norm are all-reduced, and every rank takes rank
        0's orthogonality statistic, so all ranks stop together.  The
        per-point diagnostics stay rank-local.
    trace : the fit's ``utils.tracing.FitTrace``: each iteration's
        nearest-face search closes into a ``search`` span under the
        spans open around the call (extras ``method``, ``n_points`` and
        ``n_faces``, the padded faces it scans); host clock only, no
        synchronization
    """
    corr_method = CORR_ALIASES.get(corr_method, corr_method)
    if corr_method not in CORR_METHODS:
        raise ValueError(f'unknown corr_method {corr_method!r}')
    rank = None if spmd_mesh is None else spmd_rank(spmd_mesh)
    if face_hcgc and corr_method != 'windowed':
        raise ValueError("face_hcgc requires corr_method='windowed'")
    dev = positions.device
    f32 = torch.float32
    Vp = positions.shape[0]
    N = points.shape[0]
    Fp = faces.shape[0]
    # S0, the ncc prior direction and, with use_shrink, the shrink
    # prior direction; then the classic-CG memory direction
    n_dirs0 = 3 if use_shrink else 2
    s_size = n_dirs0 + 1
    faces_l = faces.long()

    pmask3 = point_mask.to(f32)[:, None]
    el_mask = ((weights > 0) & point_mask.bool()[:, None]).to(f32)
    vmask3 = v_mask.to(f32)[:, None]
    lam2 = [float(np.float32(lam0) ** 2),
            float(np.float32(shrink_lam) ** 2)]

    corr_starts = corr_prep = corr_sub = None
    if corr_method == 'windowed':
        # anchors, point blocks and the face subsample once per CG
        # block: points are fixed and faces drift little within a block
        # (the subsample fallback still re-checks every iteration)
        centers0 = positions[faces_l].mean(1)
        corr_starts = corr.windowed_anchor_starts(points, centers0, f_mask)
        corr_prep = corr.windowed_points_prep(points)
        corr_sub = corr.subsample_ids(Fp, device=dev)
    kmajor = None if tables is None else (
        tables.ncc_idx, tables.ncc_care, tables.ncc_ov)

    n_act = num_iters if active_iters is None else int(active_iters)
    f = positions
    S_last = torch.zeros_like(positions)
    tests_hist = [float('inf')] * 3
    halted = False
    tests, ress, done = [], [], 0
    diag_state = (torch.zeros((Vp, 3, s_size), dtype=f32, device=dev),
                  torch.zeros((N, 3), dtype=f32, device=dev),
                  torch.zeros((Vp,), dtype=f32, device=dev),
                  torch.zeros((N,), dtype=f32, device=dev),
                  torch.zeros((N,), dtype=torch.int32, device=dev))

    for it in range(num_iters):
        if halted or it >= n_act:
            tests.append(float('nan'))
            ress.append(0.0)
            continue

        if tables is not None:
            tri = row_gather(f, tables.tri_idx).reshape(Fp, 3, 3)
        else:
            tri = f[faces_l]
        centers = tri.mean(1)
        vn_corners = _normals.vertex_normal_corners(f, faces, f_mask,
                                                    tri=tri)

        # --- correspondence
        search = contextlib.nullcontext() if trace is None else \
            trace.span('search', method=corr_method, n_points=N, n_faces=Fp,
                       route=corr.search_route(corr_method, dev))
        with search:
            if corr_method == 'windowed':
                dmean, fi, meta = corr.nearest_face_windowed(
                    points, centers, f_mask, return_meta=True,
                    starts=corr_starts, prep=corr_prep, sub_ids=corr_sub)
            elif corr_method == 'grid':
                dmean, fi = corr.nearest_face_grid(points, centers, f_mask,
                                                   cell_size)
            elif corr_method == 'blocked':
                # expects fit_point_order-sorted points
                dmean, fi = corr.nearest_face_blocked(points, centers,
                                                      f_mask)
            else:
                dmean, fi = corr.nearest_face_bruteforce(
                    points, centers, f_mask, face_chunk=face_chunk)
        if corr_method != 'brute' and face_nbrs is not None \
                and polish_iters > 0:
            dmean, fi = corr.refine_correspondence(
                points, centers, face_nbrs, fi, n_iter=polish_iters)
        fi_l = fi.long()
        fv9 = tri.reshape(Fp, 9)[fi_l]                       # (N, 9)
        fvj = [fv9[:, 3 * j:3 * j + 3] for j in range(3)]
        dvert = torch.stack(
            [torch.sqrt(((fj - points) ** 2).sum(-1)) for fj in fvj],
            dim=-1)
        w = 1.0 / torch.clamp(dvert, min=1e-6)
        w = w / w.sum(-1, keepdim=True)
        w = w * pmask3
        Af = fvj[0] * w[:, 0:1] + fvj[1] * w[:, 1:2] + fvj[2] * w[:, 2:3]

        # --- weighted residuals (mesh_conj_grad.py:222-248)
        res = weights * (points - Af)
        w_dist = 1.0 / (dmean[:, None] * sigma_inv / 2.0 + 1.0)
        res = res * w_dist * pmask3

        # --- A^T of [res, 1] per corner: (Fp, 12), col 4j+c
        W2 = None
        if corr_method == 'windowed':
            if face_hcgc:
                face_acc, W2 = windowed_ahw2(w, res, fi, meta.js,
                                             meta.starts, meta.sub_ids,
                                             num_segments=Fp)
            else:
                face_acc = windowed_ah(w, res, fi, meta.js, meta.starts,
                                       meta.sub_ids, num_segments=Fp)
        else:
            ah_in = torch.cat([res, pmask3], dim=1)          # (N, 4)
            per_corner = (w[..., None] * ah_in[:, None, :]).reshape(N, 12)
            face_acc = cuda_scatter.segment_sum_ordered(per_corner, fi_l,
                                                        Fp)
        if rank is not None:
            # the ranks' accumulators of their own points: one all-reduce
            if W2 is None:
                dist.all_reduce(face_acc)
            else:
                acc = torch.cat([face_acc, W2], dim=1)
                dist.all_reduce(acc)
                face_acc, W2 = acc[:, :12], acc[:, 12:]
        fused = torch.cat([vn_corners.reshape(Fp * 3, 3),
                           face_acc.reshape(Fp * 3, 4)], dim=1)  # (3Fp, 7)
        out7 = _fold(fused, faces, Vp, tables)
        vn = _normals.normalize_vertex_normals(out7[:, :3])
        S0_raw = out7[:, 3:6]
        point_influence = (3.0 ** 0.5) * torch.abs(out7[:, 6])
        ncc = compute_ncc(f, nbr_v, vn, point_influence, v_mask,
                          kmajor=kmajor)

        S0 = S0_raw * vmask3
        pref0 = (f - ncc) * vmask3
        prefs = [pref0]
        dirs = [S0, -pref0]
        if use_shrink:
            # shrink prior: f - 30 p, p = max(1 - |A^T 1|, 0) n
            # (mesh_conj_grad.py:893-909)
            p_shrink = (torch.clamp(1.0 - point_influence, min=0.0)[:, None]
                        * vn) * vmask3
            pref1 = 30.0 * p_shrink
            prefs.append(pref1)
            dirs.append(-pref1)
        dirs.append(S_last)
        S = torch.stack(dirs, dim=-1)                        # (Vp, 3, s)
        n_active = s_size if it > 0 else n_dirs0

        # --- orthogonality statistic over ordered pairs (i, j != i,
        # j >= 1) of the first n_dirs0 directions (conj_grad.py:151-162)
        def cos_abs(i, j):
            num = (S[..., i] * S[..., j]).sum()
            den = torch.linalg.norm(S[..., i]) * torch.linalg.norm(S[..., j])
            return torch.abs(num) / torch.clamp(den, min=1e-30)

        pairs = [(i, j) for i in range(n_dirs0) for j in range(1, n_dirs0)
                 if i != j]
        test = 1.0
        for (i, j) in pairs:
            test = test - cos_abs(i, j) / len(pairs)

        # --- subspace solve (conj_grad.py:183-229)
        ks = 3 * s_size
        if tables is not None:
            S_tri = row_gather(S.reshape(Vp, ks),
                               tables.tri_idx).reshape(Fp, 3 * ks)
        else:
            S_tri = S.reshape(Vp, ks)[faces_l.reshape(-1)].reshape(
                Fp, 3 * ks)
        if W2 is not None:
            # face-side normal equations: with E = A^T cols and
            # W2[f, j, j'] = sum_{n: fi = f} w_nj w_nj', the quadratic
            # forms contract over faces (valid because res is zero
            # exactly where el_mask is, which face_hcgc's caller checks)
            Sc = [S_tri[:, ks * a:ks * (a + 1)].reshape(Fp, 3, s_size)
                  for a in range(3)]
            Gc = sum(torch.einsum('fik,fi->k', Sc[j],
                                  face_acc[:, 4 * j:4 * j + 3])
                     for j in range(3))
            pair_col = {(0, 0): 0, (1, 1): 1, (2, 2): 2,
                        (0, 1): 3, (0, 2): 4, (1, 2): 5}
            Hc = torch.zeros((s_size, s_size), dtype=f32, device=dev)
            for (a, b), col in pair_col.items():
                Hab = torch.einsum('fik,fil->kl',
                                   Sc[a] * W2[:, col, None, None], Sc[b])
                Hc = Hc + (Hab if a == b else Hab + Hab.T)
        else:
            ASr = S_tri[fi_l]                                # (N, 9s)
            AS = (ASr[:, 0:ks] * w[:, 0:1] + ASr[:, ks:2 * ks] * w[:, 1:2]
                  + ASr[:, 2 * ks:] * w[:, 2:3]).reshape(N, 3, s_size)
            ASm = AS * el_mask[..., None]
            res_m = res * el_mask
            Hc = torch.einsum('nik,nil->kl', ASm, ASm)
            Gc = torch.einsum('nik,ni->k', ASm, res_m)
        if rank is not None:
            # the small reductions in one all-reduce: the point-side
            # normal equations (face-side ones are already global), the
            # residual's sum of squares, and rank 0's statistic
            test_t = torch.as_tensor(test, dtype=f32, device=dev)
            parts = [(res * res).sum()[None],
                     test_t[None] * float(rank == 0)]
            if W2 is None:
                parts += [Hc.reshape(-1), Gc]
            small = torch.cat(parts)
            dist.all_reduce(small)
            if W2 is None:
                Hc = small[2:2 + s_size * s_size].reshape(s_size, s_size)
                Gc = small[2 + s_size * s_size:]
            stats = torch.stack([small[1], torch.sqrt(small[0])])
        else:
            stats = torch.stack([torch.as_tensor(test, dtype=f32,
                                                 device=dev),
                                 torch.linalg.norm(res)])

        # L = identity for every prior: Hw = S^T S, Gw = -S^T pref
        Sv = S * vmask3[..., None]
        Hw = torch.einsum('vik,vil->kl', Sv, Sv)
        H, G = Hc, Gc
        for lam2_i, pref in zip(lam2, prefs):
            H = H + lam2_i * Hw
            G = G - lam2_i * torch.einsum('vik,vi->k', Sv, pref)

        act = (torch.arange(s_size, device=dev) < n_active).to(f32)
        H = H * act[None, :] * act[:, None] + torch.diag(1.0 - act)
        H = H + 1e-20 * torch.eye(s_size, dtype=f32, device=dev)
        G = G * act
        c = torch.linalg.solve(H, G)
        fnew = f + torch.einsum('vik,k->vi', S, c) * vmask3

        # --- stop condition (mesh_conj_grad.py:1009-1016): decided by
        # the statistics of earlier iterations; the stopping iteration
        # still reports its residual but applies no step
        a_, b_, c3 = tests_hist
        halted = (c3 < b_) and (b_ < a_) and (a_ < stop_eps)
        test_v, res_v = stats.tolist()
        ress.append(res_v)
        if halted:
            tests.append(float('nan'))
        else:
            tests.append(test_v)
            done += 1
            S_last = fnew - f
            f = fnew
            tests_hist = [tests_hist[1], tests_hist[2], test_v]
        diag_state = (S, res, point_influence, dmean, fi)

    K_out = None
    if want_curv_K and nbr_f is not None:
        # Gaussian curvature at the final positions, for the boundary
        # neck diagnostic (pyx:1516-1527)
        K_out = curvature_grad(f, faces, f_mask, v_mask, nbr_v, nbr_f).K

    S_f, res_f, pi_f, d_f, fi_f = diag_state
    diags = SolverDiagnostics(
        tests=torch.tensor(tests, dtype=f32),
        ress=torch.tensor(ress, dtype=f32),
        n_done=torch.tensor(done), S=S_f, res=res_f,
        point_influence=pi_f, d=d_f, K=K_out, fi=fi_f)
    return f, diags


def block_call(positions, faces, f_mask, v_mask, nbr_v,
               points, sigma_inv, weights, point_mask,
               lam0, shrink_lam, *, num_iters, active_iters,
               use_shrink, face_chunk, corr_method, face_nbrs,
               cell_size=1.0, tables=None, nbr_f=None, want_curv_K=False,
               face_hcgc=False, spmd_mesh=None, trace=None):
    """The one call shape of ``cg_block`` the fit loop uses."""
    return cg_block(
        positions, faces, f_mask, v_mask, nbr_v,
        points, sigma_inv, weights, point_mask,
        lam0, shrink_lam, num_iters=num_iters, active_iters=active_iters,
        use_shrink=use_shrink, face_chunk=face_chunk,
        corr_method=corr_method, cell_size=cell_size,
        face_nbrs=face_nbrs, tables=tables,
        nbr_f=nbr_f, want_curv_K=want_curv_K, face_hcgc=face_hcgc,
        spmd_mesh=spmd_mesh, trace=trace)
