"""Signed-distance-function primitive library.

Capability parity with the reference `ch_shrinkwrap/sdf.py`
(ch_shrinkwrap/sdf.py:39-292): same primitives, same
(3, N) point convention, same parameterizations (quadric-style SDFs in
the spirit of the public Inigo Quilez catalogue).  Re-implemented in a
purely functional style (no in-place fancy indexing).  numpy only; the
port keeps this copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np


def grad_sdf(pts, sdf, delta=0.1):
    """Central-difference gradient of ``sdf`` at (3, N) points."""
    d2 = delta / 2.0
    hx = np.array([d2, 0, 0])[:, None]
    hy = np.array([0, d2, 0])[:, None]
    hz = np.array([0, 0, d2])[:, None]
    dx = (sdf(pts + hx) - sdf(pts - hx)) / delta
    dy = (sdf(pts + hy) - sdf(pts - hy)) / delta
    dz = (sdf(pts + hz) - sdf(pts - hz)) / delta
    return np.stack([dx, dy, dz], axis=0)


def sdf_normals(pts, sdf, delta=0.1):
    """Unit outward normals of the level set through each (3, N) point."""
    g = grad_sdf(pts, sdf, delta=delta)
    g_norm = np.sqrt((g * g).sum(0))
    return g / np.maximum(g_norm, 1e-12)[None, :]


def sphere(p, R):
    """Sphere of radius R centred at the origin; p is (3, N)."""
    return np.sqrt((p * p).sum(0)) - R


def torus(p, r, R):
    """Torus with major radius ``r`` in the x-z plane, tube radius ``R``.

    NB: parameter naming follows the reference (sdf.py:48-58) where the
    first radius is the ring radius and the second the tube radius.
    """
    q0 = np.sqrt(p[0, :] ** 2 + p[2, :] ** 2) - r
    return np.sqrt(q0 * q0 + p[1, :] ** 2) - R


def capsule(p, a, b, r):
    """Capsule from point ``a`` to ``b`` with radius ``r``."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    pa = p - a[:, None]
    ba = b - a
    h = np.clip((pa * ba[:, None]).sum(0) / (ba * ba).sum(), 0.0, 1.0)
    d = pa - ba[:, None] * h
    return np.sqrt((d * d).sum(0)) - r


def tapered_capsule(p, r1, r2, length):
    """Capsule along +x whose radius tapers quadratically r1 -> r2."""
    x = p[0, :]
    x1 = x / length
    r = np.sqrt((p[1:, :] ** 2).sum(0))
    rx = r1 + (r2 - r1) * x1 * x1
    p2 = p - np.array([1.0, 0, 0])[:, None] * length
    d = ((x1 < 0) * (np.sqrt((p * p).sum(0)) - r1)
         + (x1 > 1) * (np.sqrt((p2 * p2).sum(0)) - r2)
         + (x1 >= 0) * (x1 <= 1) * (r - rx))
    return d


def ellipse(p, r1, r2):
    """Exact 2-D ellipse SDF with semi-axes (r1, r2); p is (2, N).

    Functional re-derivation of the iq closed-form solution used by the
    reference (sdf.py:148-188): solve for the closest point on the
    ellipse via the resolvent cubic, with the trigonometric branch when
    the discriminant is negative.
    """
    p = np.abs(p)
    ab = np.stack([r1 * np.ones_like(p[0]), r2 * np.ones_like(p[0])], axis=0)

    # Work in the branch where p0 <= p1 by symmetric swap.
    flip = p[0, :] > p[1, :]
    p0 = np.where(flip, p[1, :], p[0, :])
    p1 = np.where(flip, p[0, :], p[1, :])
    a0 = np.where(flip, ab[1, :], ab[0, :])
    a1 = np.where(flip, ab[0, :], ab[1, :])

    l = a1 * a1 - a0 * a0
    # Degenerate circle (l == 0) handled by tiny epsilon.
    l = np.where(np.abs(l) < 1e-12, 1e-12, l)
    m = a0 * p0 / l
    m2 = m * m
    n = a1 * p1 / l
    n2 = n * n
    c = (m2 + n2 - 1.0) / 3.0
    c3 = c * c * c
    q = c3 + m2 * n2 * 2.0
    d = c3 + m2 * n2
    g = m + m * n2

    # d >= 0 branch (one real root)
    h_pos = 2.0 * m * n * np.sqrt(np.maximum(d, 0.0))
    s_pos = np.cbrt(q + h_pos)
    u_pos = np.cbrt(q - h_pos)
    rx_pos = -s_pos - u_pos - c * 4.0 + 2.0 * m2
    ry_pos = (s_pos - u_pos) * np.sqrt(3.0)
    rm_pos = np.sqrt(rx_pos * rx_pos + ry_pos * ry_pos)
    co_pos = (ry_pos / np.sqrt(np.maximum(rm_pos - rx_pos, 1e-12))
              + 2.0 * g / np.maximum(rm_pos, 1e-12) - m) / 2.0

    # d < 0 branch (three real roots, trigonometric form)
    c3_safe = np.where(np.abs(c3) < 1e-30, 1e-30, c3)
    h_neg = np.arccos(np.clip(q / c3_safe, -1.0, 1.0)) / 3.0
    s_neg = np.cos(h_neg)
    t_neg = np.sin(h_neg) * np.sqrt(3.0)
    rx_neg = np.sqrt(np.maximum(-c * (s_neg + t_neg + 2.0) + m2, 0.0))
    ry_neg = np.sqrt(np.maximum(-c * (s_neg - t_neg + 2.0) + m2, 0.0))
    denom = np.maximum(rx_neg * ry_neg, 1e-12)
    co_neg = (ry_neg + np.sign(l) * rx_neg + np.abs(g) / denom - m) / 2.0

    co = np.where(d < 0.0, co_neg, co_pos)
    co = np.clip(co, 0.0, 1.0)

    r0 = a0 * co
    r1_ = a1 * np.sqrt(np.maximum(1.0 - co * co, 0.0))
    dist = np.sqrt((r0 - p0) ** 2 + (r1_ - p1) ** 2)
    return dist * np.sign(p1 - r1_)


def tapered_ellipsoid(p, r1, r2, length):
    """Ellipsoid-capped tapered tube along +x (reference sdf.py:110-146)."""
    x = p[0, :]
    x1 = x / length
    rx = r1 + (r2 - r1) * x1 * x1
    p2 = p - np.array([1.0, 0, 0])[:, None] * length

    rr1 = np.array([r1, r1, r1 / 2.0])
    rr2 = np.array([r2, r2, r2 / 2.0])
    k0r1 = np.sqrt(((p / rr1[:, None]) ** 2).sum(0))
    k1r1 = np.sqrt(((p / (rr1 ** 2)[:, None]) ** 2).sum(0))
    k0r2 = np.sqrt(((p2 / rr2[:, None]) ** 2).sum(0))
    k1r2 = np.sqrt(((p2 / (rr2 ** 2)[:, None]) ** 2).sum(0))

    d = ((x1 < 0) * k0r1 * (k0r1 - 1.0) / np.maximum(k1r1, 1e-12)
         + (x1 > 1) * k0r2 * (k0r2 - 1.0) / np.maximum(k1r2, 1e-12)
         + (x1 >= 0) * (x1 <= 1) * ellipse(p[1:, :], rx, rx / 2.0))
    return d


def round_cone(p, r1, r2, length):
    """Cone with spherical caps of radii r1 (base) and r2 (tip)."""
    b = (r1 - r2) / length
    a = np.sqrt(1.0 - b * b)
    q = np.stack([np.sqrt(p[0, :] ** 2 + p[2, :] ** 2), p[1, :]], axis=0)
    k = (q * np.array([-b, a])[:, None]).sum(0)
    qn = np.sqrt((q * q).sum(0))
    qln = np.sqrt(((q - np.array([0.0, length])[:, None]) ** 2).sum(0))
    d_mid = (q * np.array([a, b])[:, None]).sum(0) - r1
    d = np.where(k < 0.0, qn - r1, np.where(k > a * length, qln - r2, d_mid))
    return d


def tetrahedron(p, v0, v1, v2, v3):
    """Tetrahedron SDF as max over the four outward face planes.

    ``p`` is (N, 3) here, matching the reference convention
    (sdf.py:204-248; requires the orient_simps vertex ordering).
    """
    from ..utils.math import fast_3x3_cross, fast_sum

    p = np.atleast_2d(p)
    v01 = v1 - v0
    v12 = v2 - v1
    v03 = v3 - v0
    v23 = v3 - v2

    n021 = fast_3x3_cross(-v01, v12)
    n013 = fast_3x3_cross(v01, v03)
    n032 = fast_3x3_cross(-v23, -v03)
    n123 = fast_3x3_cross(v23, -v12)

    nn021 = n021 * (fast_sum(n021 * n021) ** (-0.5))
    nn013 = n013 * (fast_sum(n013 * n013) ** (-0.5))
    nn032 = n032 * (fast_sum(n032 * n032) ** (-0.5))
    nn123 = n123 * (fast_sum(n123 * n123) ** (-0.5))

    pv0 = p - v0
    p021 = (nn021 * pv0).sum(1)
    p013 = (nn013 * pv0).sum(1)
    p032 = (nn032 * pv0).sum(1)
    p123 = (nn123 * (p - v1)).sum(1)

    return np.max(np.stack([p021, p013, p032, p123], axis=1), axis=1)


def round_box(p, w, r):
    """Box of halfwidths ``w`` with corners rounded by radius ``r``."""
    w = np.asarray(w, dtype=float)
    q = np.abs(p) - w[:, None]
    outside = np.sqrt((np.maximum(q, 0.0) ** 2).sum(0))
    inside = np.minimum(np.maximum(q[0, :], np.maximum(q[1, :], q[2, :])), 0.0)
    return outside + inside - r


def sheet(p, w, r):
    """Dumbbell-edged sheet: box with bulbed rims (reference sdf.py:271-292)."""
    w = np.asarray(w, dtype=float)
    q = np.abs(p) - w[:, None]
    m = np.maximum(q[0, :], np.maximum(q[1, :], q[2, :]))
    rim = np.sqrt((np.maximum(q[0, :], q[1, :]) + r) ** 2
                  + (q[2, :] + w[2]) ** 2) - r
    return np.minimum(rim, m)
