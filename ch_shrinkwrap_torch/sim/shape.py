"""Shape / CSG library over signed-distance functions.

Capability parity with the reference `ch_shrinkwrap/shape.py`
(the reference ch_shrinkwrap/shape.py:19-504): Shape objects with
Monte-Carlo surface sampling, localization noise, analytic area/volume
where known, CSG combinators (smooth union/difference/intersection),
rotation/bend modifiers and the named test structures used by the
evaluation suite.  Surface sampling is our own implementation
(`pointcloud.points_from_sdf`) since the reference delegates that to
PYME (`PYME.simulation.locify.points_from_sdf`), which we do not depend
on.  All randomness flows through explicit seeded generators.
"""

from __future__ import annotations

import math

import numpy as np

from . import sdf
from .pointcloud import points_from_sdf
from ..utils.math import fast_3x3_cross, dot2, loc_error, _rng


class Shape:
    """Base class for constructive-solid-geometry test shapes."""

    def __init__(self, **kwargs):
        self._density = None
        self._points = None
        self._sigma = None
        self._normals = None
        self._radius = None      # bounding radius of the shape
        self.centroid = np.array([0, 0, 0], dtype=float)
        for k, v in kwargs.items():
            setattr(self, k, v)

    @property
    def surface_area(self):
        raise NotImplementedError('Implemented in a derived class.')

    @property
    def volume(self):
        raise NotImplementedError('Implemented in a derived class.')

    def sdf(self, points):
        """Signed distance at (3, N) points."""
        raise NotImplementedError('Implemented in a derived class')

    def __noise(self, model='exponential', rng=None, **kw):
        self._sigma = loc_error(self._points.shape, model, rng=rng, **kw)
        return self._sigma * _rng(rng).standard_normal(self._sigma.shape)

    def points(self, density=1, p=0.1, resample=False, noise='exponential',
               psf_width=280.0, mean_photon_count=600, bg_photon_count=20,
               return_normals=False, rng=None):
        """Monte-Carlo sample of detected fluorophores on the surface.

        Parameters mirror the reference (shape.py:57-86): ``density`` in
        fluorophores/nm sets the sampling pitch dx_min = density^(-1/3),
        ``p`` is the per-fluorophore detection probability, and ``noise``
        jitters each detection by its localization error.
        Returns an (N, 3) array.
        """
        rng = _rng(rng)
        if resample or (self._points is None) or (self._density != density):
            self._density = density
            self._points = points_from_sdf(
                self.sdf, r_max=self._radius, centre=self.centroid,
                dx_min=(1.0 / density) ** (1.0 / 3.0), p=p, rng=rng).T
            if noise and psf_width is not None:
                self._points = self._points + self.__noise(
                    noise, rng=rng, psf_width=psf_width,
                    mean_photon_count=mean_photon_count,
                    bg_photon_count=bg_photon_count)
            else:
                self._sigma = loc_error(self._points.shape, None)
            if return_normals:
                self._normals = sdf.sdf_normals(self._points.T, self.sdf).T

        if return_normals:
            return self._points, self._normals
        return self._points

    def surface_res(self, points):
        return np.sum(self.sdf(points) ** 2)

    def mse(self, points):
        return self.surface_res(points) / points.shape[1]


class Sphere(Shape):
    def __init__(self, radius=2, **kwargs):
        Shape.__init__(self, **kwargs)
        self._radius = radius

    @property
    def surface_area(self):
        return 4 * np.pi * self._radius ** 2

    @property
    def volume(self):
        return (4.0 / 3.0) * np.pi * self._radius ** 3

    def sdf(self, p):
        return sdf.sphere(p - self.centroid[:, None], self._radius)


class Torus(Shape):
    def __init__(self, radius=2, r=0.05, R=None, **kwargs):
        Shape.__init__(self, **kwargs)
        # accept the sweep-config spelling {r, R} (the reference's
        # Torus silently drops R= into an unused attribute and keeps
        # the default ring radius — shape.py:110-114; fixed here)
        self._radius = radius if R is None else R
        self._r = r             # minor (tube) radius

    @property
    def surface_area(self):
        return 4 * np.pi * np.pi * self._radius * self._r

    @property
    def volume(self):
        return 2 * np.pi * np.pi * self._radius * self._r * self._r

    def sdf(self, p):
        return sdf.torus(p - self.centroid[:, None], self._radius, self._r)


class Tetrahedron(Shape):
    def __init__(self, v0, v1, v2, v3, **kwargs):
        Shape.__init__(self, **kwargs)
        # accept plain lists (YAML sweep configs) as well as arrays
        v0, v1, v2, v3 = (np.asarray(v, dtype=float)
                          for v in (v0, v1, v2, v3))
        # sdf.tetrahedron's face planes are outward only for positively
        # oriented vertices (the reference requires orient_simps order,
        # sdf.py:204); canonicalize so any YAML ordering works
        if np.dot(np.cross(v1 - v0, v2 - v0), v3 - v0) < 0:
            v1, v2 = v2, v1
        d = [dot2(a - b) for a, b in ((v0, v1), (v0, v2), (v0, v3),
                                      (v1, v2), (v1, v3), (v2, v3))]
        self._radius = np.sqrt(np.max(d))
        self._v0, self._v1, self._v2, self._v3 = v0, v1, v2, v3

    @property
    def surface_area(self):
        v01 = self._v1 - self._v0
        v12 = self._v2 - self._v1
        v03 = self._v3 - self._v0
        v23 = self._v3 - self._v2
        a021 = np.sqrt((fast_3x3_cross(-v01, v12) ** 2).sum())
        a013 = np.sqrt((fast_3x3_cross(v01, v03) ** 2).sum())
        a032 = np.sqrt((fast_3x3_cross(-v23, -v03) ** 2).sum())
        a123 = np.sqrt((fast_3x3_cross(v23, -v12) ** 2).sum())
        return a021 + a013 + a032 + a123

    @property
    def volume(self):
        v30 = self._v0 - self._v3
        v31 = self._v1 - self._v3
        v32 = self._v2 - self._v3
        return (1 / 6) * abs((v30 * fast_3x3_cross(v31, v32)).sum())

    def sdf(self, p):
        # tetrahedron takes (N, 3) points
        return sdf.tetrahedron(np.asarray(p).T, self._v0, self._v1,
                               self._v2, self._v3)


class Capsule(Shape):
    def __init__(self, start, end, radius=1, **kwargs):
        Shape.__init__(self, **kwargs)
        self._start = np.array(start, dtype=float)
        self._end = np.array(end, dtype=float)
        self._r = radius
        self._length = math.sqrt(dot2(self._end - self._start))
        self._radius = self._length / 2.0 + radius
        self.centroid = self.centroid + 0.5 * (self._start + self._end)

    @property
    def volume(self):
        return np.pi * self._r ** 2 * ((4.0 / 3.0) * self._r + self._length)

    @property
    def surface_area(self):
        return 2.0 * np.pi * self._r * (2.0 * self._r + self._length)

    def sdf(self, p):
        return sdf.capsule(p, self._start, self._end, self._r)


class TaperedCapsule(Shape):
    def __init__(self, r1, r2, length=1, **kwargs):
        Shape.__init__(self, **kwargs)
        self._r1, self._r2, self._length = r1, r2, length
        self._radius = (length + max(r1, r2)) / 2.0
        self.centroid = np.array([length / 2.0, 0, 0], dtype=float)

    def sdf(self, p):
        return sdf.tapered_capsule(p, self._r1, self._r2, self._length)


class TaperedEllipsoid(Shape):
    def __init__(self, r1, r2, length=1, **kwargs):
        Shape.__init__(self, **kwargs)
        self._r1, self._r2, self._length = r1, r2, length
        self._radius = (length + max(r1, r2)) / 2.0
        self.centroid = np.array([length / 2.0, 0, 0], dtype=float)

    def sdf(self, p):
        return sdf.tapered_ellipsoid(p, self._r1, self._r2, self._length)


class RoundCone(Shape):
    def __init__(self, r1, r2, length=1, **kwargs):
        Shape.__init__(self, **kwargs)
        self._r1, self._r2, self._length = r1, r2, length
        self._radius = max(r1, r2, length) / 2.0

    def sdf(self, p):
        return sdf.round_cone(p, self._r1, self._r2, self._length)


class Box(Shape):
    def __init__(self, halfwidth, r=0, **kwargs):
        Shape.__init__(self, **kwargs)
        self._r = r
        self._halfwidth = np.array(halfwidth)
        self._radius = float(np.max(halfwidth))

    @property
    def volume(self):
        return float(np.prod(2.0 * self._halfwidth))

    @property
    def surface_area(self):
        w = 2.0 * self._halfwidth
        return 2.0 * (w[0] * w[1] + w[1] * w[2] + w[0] * w[2])

    def sdf(self, p):
        return sdf.round_box(p - self.centroid[:, None], self._halfwidth, self._r)


class Sheet(Shape):
    def __init__(self, halfwidth, r=0, **kwargs):
        Shape.__init__(self, **kwargs)
        self._r = r
        self._halfwidth = np.array(halfwidth)
        self._radius = float(np.max(halfwidth))

    def sdf(self, p):
        return sdf.sheet(p - self.centroid[:, None], self._halfwidth, self._r)


def ThreeWayJunction(h, r, centroid=[0, 0, 0], k=0):
    centroid = np.array(centroid, dtype=float)
    return UnionShape(
        Capsule(centroid, centroid + [0, -h, 0], r),
        UnionShape(
            Capsule(centroid, centroid + [-h / np.sqrt(2), h / np.sqrt(2), 0], r),
            Capsule(centroid, centroid + [h / np.sqrt(2), h / np.sqrt(2), 0], r), k
        ),
        k=0, centroid=centroid,
    )


def ERSim(centroid=[0, 0, 0]):
    """Endoplasmic-reticulum-like test structure (reference shape.py:263)."""
    sheet_height = 100  # nm
    a, b = np.array([0, 0, 0]), np.array([400, -50, 0])
    c, d = np.array([500, 250, 0]), np.array([0, 217, 0])
    e, f = np.array([0, -400, 0]), np.array([-400, 0, 0])

    sheet0 = RotationShape(Box(np.array([66, 83, sheet_height / 4]), sheet_height / 4), rz=np.pi / 4)
    sheet1 = Box(np.array([50, 50, sheet_height // 4]), 1, centroid=np.array([0, 133, 0]))
    sheet2 = RotationShape(Box(np.array([33, 33, sheet_height / 4]), sheet_height / 4), rz=7 * np.pi / 3, centroid=c)
    cap0 = Capsule(a, b, sheet_height // 2)
    cap1 = Capsule(b, c, sheet_height // 2)
    cap2 = Capsule(c, d, sheet_height // 2)
    cap3 = Capsule(a, e, sheet_height // 2)
    cap4 = Capsule(a, f, sheet_height // 2)
    smooth = sheet_height // 4
    return UnionShape(UnionShape(UnionShape(
        UnionShape(sheet0,
                   UnionShape(cap0,
                              UnionShape(cap1,
                                         UnionShape(sheet2, cap2, k=smooth),
                                         k=sheet_height), k=smooth),
                   k=smooth),
        sheet1, k=smooth), cap3, k=smooth), cap4, k=smooth)


def ERSim2(centroid=[0, 0, 0]):
    sheet_height = 100  # nm
    a, b = np.array([0, 0, 0]), np.array([400, -50, 0])
    c, d = np.array([500, 250, 0]), np.array([0, 240, 0])
    e, f = np.array([0, -600, 0]), np.array([-600, 0, 0])
    g, h = np.array([-40, 0, -100]), np.array([-40, 0, 100])

    sheet0 = RotationShape(Sheet(np.array([226, 200, sheet_height / 3]), sheet_height / 3), rz=np.pi / 4)
    sheet1 = Sheet(np.array([50, 50, sheet_height / 3]), 1, centroid=np.array([0, 133, 0]))
    sheet2 = RotationShape(Sheet(np.array([33, 33, sheet_height / 3]), sheet_height / 2), rz=7 * np.pi / 3, centroid=c)
    cap0 = Capsule(a, b, sheet_height // 2)
    cap1 = Capsule(b, c, sheet_height // 2)
    cap2 = Capsule(c, d, sheet_height // 2)
    cap3 = Capsule(a, e, sheet_height // 2)
    cap4 = Capsule(a, f, sheet_height // 2)
    cap5 = Capsule(g, h, 50)
    smooth = sheet_height / 4
    return DifferenceShape(cap5, UnionShape(UnionShape(UnionShape(
        UnionShape(sheet0,
                   UnionShape(cap0,
                              UnionShape(cap1,
                                         UnionShape(sheet2, cap2, k=smooth),
                                         k=smooth), k=smooth),
                   k=smooth),
        sheet1, k=smooth), cap3, k=smooth), cap4, k=smooth), k=smooth)


TwoToruses = lambda r, R: UnionShape(
    Torus(radius=R, r=r, centroid=np.array([-R, 0, 0])),
    Torus(radius=R, r=r, centroid=np.array([R, 0, 0])))


def NToruses(toruses, centroid=np.array([0, 0, 0])):
    """Chain of N toruses from a dict of {name: {'r': .., 'R': ..}}."""
    toruses = dict(toruses)
    dt = toruses.pop(next(iter(toruses)))
    dcentroid = centroid.copy().astype(float)
    if dcentroid[0] > 0:
        dcentroid[0] += float(dt['R'])

    torus = Torus(radius=float(dt['R']), r=float(dt['r']), centroid=dcentroid)
    if len(toruses) == 0:
        return torus

    n = len(toruses)
    return UnionShape(torus, NToruses(toruses, dcentroid + np.array([dt['R'], 0, 0])), n=n)


def DualCapsule(length, r, sep):
    return UnionShape(
        Capsule(start=np.array([-sep / 2, 0, 0]), end=np.array([-sep / 2, length, 0]), radius=r),
        Capsule(start=np.array([sep / 2, 0, 0]), end=np.array([sep / 2, length, 0]), radius=r))


def CollinearCapsules(length, r, gap):
    """Two capsules on one axis with ``gap`` between their rounded
    tips: the density seed bridges the gap with a LOCALIZED tube — a
    genuine neck (unlike ``DualCapsule``, whose side-by-side bodies
    weld along their whole length into a seam no neck pass can cut).
    ``gap`` is between the SURFACES (the rounded tips extend ``r``
    beyond the segment ends).  Truth topology: two components,
    euler 4."""
    tip = gap / 2 + r
    return UnionShape(
        Capsule(start=np.array([-tip - length, 0, 0]),
                end=np.array([-tip, 0, 0]), radius=r),
        Capsule(start=np.array([tip, 0, 0]),
                end=np.array([tip + length, 0, 0]), radius=r))


class UnionShape(Shape):
    """Smooth union of two shapes (polynomial smooth-min with radius k)."""

    def __init__(self, s0, s1, k=0, n=1, **kwargs):
        Shape.__init__(self, **kwargs)
        self._s0, self._s1, self._k = s0, s1, k
        self._radius = s0._radius + s1._radius
        self.centroid = (1.0 / (n + 1)) * (s0.centroid + n * s1.centroid)

    def sdf(self, p):
        d0 = self._s0.sdf(p)
        d1 = self._s1.sdf(p)
        res = np.minimum(d0, d1)
        if self._k > 0:
            h = np.maximum(self._k - np.abs(d0 - d1), 0.0)
            return res - h * h * 0.25 / self._k
        return res


class DifferenceShape(Shape):
    """s1 minus s0, smooth with radius k."""

    def __init__(self, s0, s1, k=0, **kwargs):
        Shape.__init__(self, **kwargs)
        self._s0, self._s1, self._k = s0, s1, k
        if s0._radius > s1._radius:
            self._radius, self.centroid = s0._radius, s0.centroid
        else:
            self._radius, self.centroid = s1._radius, s1.centroid

    def sdf(self, p):
        d0 = self._s0.sdf(p)
        d1 = self._s1.sdf(p)
        res = np.maximum(-d0, d1)
        if self._k > 0:
            h = np.maximum(self._k - np.abs(-d0 - d1), 0.0)
            return res + h * h * 0.25 / self._k
        return res


class IntersectionShape(Shape):
    def __init__(self, s0, s1, k=0, **kwargs):
        Shape.__init__(self, **kwargs)
        self._s0, self._s1, self._k = s0, s1, k
        if s0._radius < s1._radius:
            self._radius, self.centroid = s0._radius, s0.centroid
        else:
            self._radius, self.centroid = s1._radius, s1.centroid

    def sdf(self, p):
        d0 = self._s0.sdf(p)
        d1 = self._s1.sdf(p)
        res = np.maximum(d0, d1)
        if self._k > 0:
            h = np.maximum(self._k - np.abs(d0 - d1), 0.0)
            return res + h * h * 0.25 / self._k
        return res


class RotationShape(Shape):
    """Rotate a shape by Euler angles (rx, ry, rz)."""

    def __init__(self, s0, rx=0.0, ry=0.0, rz=0.0, **kwargs):
        Shape.__init__(self, **kwargs)
        self._s0 = s0

        sinx, cosx = np.sin(rx), np.cos(rx)
        siny, cosy = np.sin(ry), np.cos(ry)
        sinz, cosz = np.sin(rz), np.cos(rz)
        _rx = np.array([[1, 0, 0], [0, cosx, -sinx], [0, sinx, cosx]])
        _ry = np.array([[cosy, 0, siny], [0, 1, 0], [-siny, 0, cosy]])
        _rz = np.array([[cosz, -sinz, 0], [sinz, cosz, 0], [0, 0, 1]])
        self._inv_r = np.linalg.inv(_rz @ (_ry @ _rx))

        self._radius = s0._radius
        if 'centroid' not in kwargs:
            self.centroid = s0.centroid

    def sdf(self, p):
        return self._s0.sdf(self._inv_r @ (p - self.centroid[:, None]))
