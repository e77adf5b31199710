"""One-ring curvature tensor + Canham-Helfrich energy on torch tensors.

Counterpart of the JAX package's ``ops/curvature.py`` (itself a rebuild
of the reference's ``c_curvature_grad``,
ch_shrinkwrap/membrane_mesh_utils.c:915-1250): one batched pass over all
vertices through the padded one-ring neighbour table —

pass 1  radial weights and edge tangents of the <=20-vertex ring;
pass 2  signed edge curvatures, least-squares second fundamental form
        (or the Taubin tensor with ``method='taubin'``), closed-form
        2x2 eigendecomposition;
pass 3  normal-displaced quadric for dH, dK and the energy gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import normals as _normals

KBT = 0.0257  # eV, matches DEF KBT (_membrane_mesh.pyx:22)


class CurvatureState(NamedTuple):
    """Per-vertex curvature quantities (padded length Vp)."""
    k_0: Optional[torch.Tensor]       # principal curvature 0 (1/nm)
    k_1: Optional[torch.Tensor]       # principal curvature 1 (1/nm)
    e_0: Optional[torch.Tensor]       # (Vp, 3) principal direction 0
    e_1: Optional[torch.Tensor]       # (Vp, 3) principal direction 1
    H: Optional[torch.Tensor]         # mean curvature (1/nm)
    K: Optional[torch.Tensor]         # Gaussian curvature (1/nm^2)
    dH: Optional[torch.Tensor]        # dH/dN (1/nm^2)
    dK: Optional[torch.Tensor]        # dK/dN (1/nm)
    E: Optional[torch.Tensor]         # Canham-Helfrich energy (eV)
    pE: Optional[torch.Tensor]        # exp(-E/kBT)
    dE_neighbors: Optional[torch.Tensor]
    dEdN: Optional[torch.Tensor]      # (Vp, 3) energy gradient


def householder_tangent_basis(n):
    """Two orthonormal tangent vectors per unit normal n (V, 3):
    columns 1 and 2 of the Householder reflection mapping e_x onto
    -sign(n_x) n."""
    sign = torch.where(n[..., 0] >= 0, 1.0, -1.0).to(n.dtype)
    u = torch.stack([n[..., 0] + sign, n[..., 1], n[..., 2]], dim=-1)
    uu = (u * u).sum(-1)
    e1 = torch.stack([-2 * u[..., 0] * u[..., 1] / uu,
                      1 - 2 * u[..., 1] * u[..., 1] / uu,
                      -2 * u[..., 2] * u[..., 1] / uu], dim=-1)
    e2 = torch.stack([-2 * u[..., 0] * u[..., 2] / uu,
                      -2 * u[..., 1] * u[..., 2] / uu,
                      1 - 2 * u[..., 2] * u[..., 2] / uu], dim=-1)
    return e1, e2


def eig_2x2_symmetric(a, b, c):
    """Eigenvalues (ascending) + rotation (cos, sin) of [[a, b], [b, c]]."""
    tr = a + c
    disc = torch.sqrt((a - c) ** 2 + 4 * b * b)
    l1 = 0.5 * (tr - disc)
    l2 = 0.5 * (tr + disc)
    theta = 0.5 * torch.atan2(2 * b, a - c)
    return l1, l2, torch.cos(theta), torch.sin(theta)


def curvature_grad(positions, faces, f_mask, v_mask, nbr_v, nbr_f,
                   kc=20.0 * KBT, kg=-20.0 * KBT, c0=0.0, dN=0.1,
                   skip_generator=None, skip_prob=0.0, method='lsq'):
    """CurvatureState for every vertex in one batch.  Monte-Carlo
    vertex skipping draws from ``skip_generator`` (a
    ``torch.Generator`` on the tensors' device)."""
    Vp = positions.shape[0]
    vm = v_mask.bool()

    vnormals = _normals.vertex_normals(positions, faces, f_mask, Vp)
    _, face_areas = _normals.face_geometry(positions, faces, f_mask)

    nmask = (nbr_v >= 0) & vm[:, None]              # (Vp, K)
    nm = nmask.to(positions.dtype)
    safe_nbr = nbr_v.long().clamp(0, Vp - 1)
    safe_nbr_f = nbr_f.long().clamp(0, faces.shape[0] - 1)

    def inv_or0(x):
        return torch.where(nmask, 1.0 / torch.clamp(x, min=1e-12),
                           torch.zeros_like(x))

    vi = positions
    Nvi = vnormals
    vjs = positions[safe_nbr]                        # (Vp, K, 3)
    Nvjs = vnormals[safe_nbr]

    dvs = torch.where(nmask[..., None], vjs - vi[:, None, :],
                      torch.zeros_like(vjs))
    dvs_norm = torch.sqrt((dvs * dvs).sum(-1))
    inv_dv = inv_or0(dvs_norm)
    r_sum = inv_dv.sum(-1)

    dvs_1 = dvs - (Nvi * dN)[:, None, :] * nm[..., None]
    dvs_1_norm = torch.sqrt((dvs_1 * dvs_1).sum(-1))

    dvs_hat = dvs * inv_or0(dvs_norm)[..., None]
    dvs_1_hat = dvs_1 * inv_or0(dvs_1_norm)[..., None]

    ndotdv = (Nvi[:, None, :] * dvs).sum(-1)
    T = -(dvs - ndotdv[..., None] * Nvi[:, None, :])
    T_norm = torch.sqrt((T * T).sum(-1))
    Tij = T * torch.where(T_norm > 1e-12,
                          1.0 / torch.clamp(T_norm, min=1e-12),
                          torch.zeros_like(T_norm))[..., None]

    def normal_diff(nv, hat):
        d = (nv * hat).sum(-1)
        inner = torch.sqrt(torch.clamp(1.0 - d * d, 0.0, 1.0))
        return torch.sqrt(torch.clamp(2.0 - 2.0 * inner, min=0.0))

    Ni_diffs = normal_diff(Nvi[:, None, :], dvs_hat)
    Nj_diffs = normal_diff(Nvjs, dvs_hat)
    Nj_1_diffs = normal_diff(Nvjs, dvs_1_hat)

    kjs = 2.0 * Nj_diffs * inv_dv
    kjs_1 = torch.where(nmask, 2.0 * Nj_1_diffs
                        / torch.clamp(dvs_1_norm, min=1e-12),
                        torch.zeros_like(dvs_1_norm))

    k_edge = 2.0 * torch.sign(-ndotdv) * Ni_diffs * inv_dv
    w = inv_dv / torch.clamp(r_sum, min=1e-12)[:, None]

    Aj = torch.where(nmask, face_areas[safe_nbr_f],
                     torch.zeros_like(inv_dv))
    areas = Aj.sum(-1)

    dEj = Aj * w * kc * (2.0 * kjs - c0) * (kjs_1 - kjs) / dN
    dE_neighbors = dEj.sum(-1)

    e1, e2 = householder_tangent_basis(Nvi)
    t1 = (Tij * e1[:, None, :]).sum(-1)
    t2 = (Tij * e2[:, None, :]).sum(-1)

    wk = w * k_edge
    m00 = (wk * t1 * t1).sum(-1)
    m01 = (wk * t1 * t2).sum(-1)
    m11 = (wk * t2 * t2).sum(-1)
    if method == 'taubin':
        l1, l2, ct, st = eig_2x2_symmetric(m00, m01, m11)
        k_0 = 3.0 * l1 - l2
        k_1 = 3.0 * l2 - l1
    else:
        zero = torch.zeros_like(t1)
        X0 = torch.where(nmask, t1 * t1, zero)
        X1 = torch.where(nmask, 2.0 * t1 * t2, zero)
        X2 = torch.where(nmask, t2 * t2, zero)
        y = k_edge

        def dotk(a_, b_):
            return (w * a_ * b_).sum(-1)

        g00, g01, g02 = dotk(X0, X0), dotk(X0, X1), dotk(X0, X2)
        g11, g12, g22 = dotk(X1, X1), dotk(X1, X2), dotk(X2, X2)
        r0, r1, r2 = dotk(X0, y), dotk(X1, y), dotk(X2, y)

        c00 = g11 * g22 - g12 * g12
        c01 = g02 * g12 - g01 * g22
        c02 = g01 * g12 - g02 * g11
        c11 = g00 * g22 - g02 * g02
        c12 = g01 * g02 - g00 * g12
        c22 = g00 * g11 - g01 * g01
        det = g00 * c00 + g01 * c01 + g02 * c02
        okd = torch.abs(det) > 1e-10
        invd = torch.where(okd, 1.0 / torch.where(okd, det,
                                                  torch.ones_like(det)),
                           torch.zeros_like(det))
        a_ = (c00 * r0 + c01 * r1 + c02 * r2) * invd
        b_ = (c01 * r0 + c11 * r1 + c12 * r2) * invd
        c_ = (c02 * r0 + c12 * r1 + c22 * r2) * invd

        # Taubin fallback on singular rings
        tl1, tl2, _, _ = eig_2x2_symmetric(m00, m01, m11)
        a_ = torch.where(okd, a_, 3.0 * tl1 - tl2)
        b_ = torch.where(okd, b_, torch.zeros_like(b_))
        c_ = torch.where(okd, c_, 3.0 * tl2 - tl1)
        k_0, k_1, ct, st = eig_2x2_symmetric(a_, b_, c_)

    v2 = ct[:, None] * e1 + st[:, None] * e2
    v1 = -st[:, None] * e1 + ct[:, None] * e2
    H = 0.5 * (k_0 + k_1)
    K = k_0 * k_1

    zero = torch.zeros_like(t1)
    s1 = (dvs * v1[:, None, :]).sum(-1)
    s2 = (dvs * v2[:, None, :]).sum(-1)
    A1 = torch.where(nmask, s1 * s1, zero)
    A2 = torch.where(nmask, s2 * s2, zero)
    b = A1 * k_0[:, None] + A2 * k_1[:, None] - dN

    ata00 = (A1 * A1).sum(-1)
    ata01 = (A1 * A2).sum(-1)
    ata11 = (A2 * A2).sum(-1)
    atb0 = (A1 * b).sum(-1)
    atb1 = (A2 * b).sum(-1)
    det = ata00 * ata11 - ata01 * ata01
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det,
                                                torch.ones_like(det)),
                          torch.zeros_like(det))
    kp0 = (ata11 * atb0 - ata01 * atb1) * inv_det
    kp1 = (-ata01 * atb0 + ata00 * atb1) * inv_det
    kp0 = torch.where(ok, kp0, k_0)
    kp1 = torch.where(ok, kp1, k_1)

    dH = (0.5 * (kp0 + kp1) - H) / dN
    dK = ((kp0 - k_0) * k_1 + k_0 * (kp1 - k_1)) / dN

    E = areas * (0.5 * kc * (2.0 * H - c0) ** 2 + kg * K)
    pE = torch.exp(-E / KBT)

    dEdN_H = areas * kc * (2.0 * H - c0) * dH
    dEdN_K = areas * kg * dK
    dEdN_sum = dEdN_H + dEdN_K + dE_neighbors
    dEdN = -dEdN_sum[:, None] * Nvi

    valid = vm & nmask.any(-1)
    if skip_generator is not None and skip_prob > 0.0:
        keep = torch.rand((Vp,), generator=skip_generator,
                          device=positions.device) >= skip_prob
        valid = valid & keep

    def z(x):
        return torch.where(valid, x, torch.zeros_like(x)).float()

    def zv(x):
        return torch.where(valid[:, None], x, torch.zeros_like(x)).float()

    return CurvatureState(
        k_0=z(k_0), k_1=z(k_1), e_0=zv(v1), e_1=zv(v2), H=z(H), K=z(K),
        dH=z(dH), dK=z(dK), E=z(E), pE=z(pE),
        dE_neighbors=z(dE_neighbors), dEdN=zv(dEdN))
