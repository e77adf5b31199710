"""The ERSim cell's acquisition, drawn from the seed.

A frozen NumPy copy of what the port's
``sim.pointcloud.generate_smlm_pointcloud_from_shape('ERSim', {}, ...)``
does: surface sites on the shape's zero level set (``points_from_sdf``
over the shape's bounding radius about its centroid), thinned by the
detection probability and jittered by the photon model's error; each
localization resampled from a cluster of re-detections
(``smlmify_points``); then a uniform background, ``noise_fraction`` of
the whole, over the cloud's box scaled by 1.2 about the origin, resampled
the same way.  Every draw comes from one ``numpy.random.default_rng(seed)``
in the port's order.

The signed distance is ``reference/shapes/ersim.py``'s, so nothing here
imports the program: a later change to the port's ``sim/`` cannot change
the cell's data.  That SDF turns the sheets with plain products and sums
where the port calls a BLAS matrix product, so the two part in the
last bit at some points; ``benchmark/tests/test_bench_sweep_cpu_run.py``
holds the acquisition to the port's on three seeds.
"""

import math

import numpy as np
import torch

from .reference.shapes import ersim

CLUSTER = 10            # re-detections a localization is resampled from
BOX_SCALE = 1.2         # the background's box, about the origin
CHUNK = 1 << 16         # points a call of the SDF


def _capsule(a, b, r):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return math.sqrt(((b - a) * (b - a)).sum()) / 2.0 + r, 0.5 * (a + b)


def _union(s0, s1):
    return s0[0] + s1[0], 0.5 * (s0[1] + s1[1])


def bounds():
    """(r_max, centroid) of the ERSim as the upstream shape tree gives
    them: a union's radius is the sum of its parts', its centroid their
    mean; a box's radius is its largest half-width, a capsule's half its
    length plus its radius, about its midpoint."""
    r = ersim.SHEET // 2
    sheet0 = (83.0, np.zeros(3))
    sheet1 = (50.0, np.array([0.0, 133.0, 0.0]))
    sheet2 = (33.0, np.asarray(ersim.C, float))
    tree = _union(sheet0, _union(
        _capsule(ersim.A, ersim.B, r), _union(
            _capsule(ersim.B, ersim.C, r),
            _union(sheet2, _capsule(ersim.C, ersim.D, r)))))
    tree = _union(_union(_union(tree, sheet1),
                         _capsule(ersim.A, ersim.E, r)),
                  _capsule(ersim.A, ersim.F, r))
    return tree


def sdf(p):
    """The ERSim's signed distance at (3, n) float64 points, in chunks
    that stay in cache (each point's value is the same at any chunk
    size)."""
    q = torch.from_numpy(np.ascontiguousarray(p.T))
    return torch.cat([ersim.sdf(q[i:i + CHUNK])
                      for i in range(0, q.shape[0], CHUNK)]).numpy()


def _normals(p, delta):
    """Unit gradients of the SDF by central differences."""
    d2 = delta / 2.0
    g = []
    for k in range(3):
        h = np.zeros((3, 1))
        h[k] = d2
        g.append((sdf(p + h) - sdf(p - h)) / delta)
    g = np.stack(g, axis=0)
    norm = np.sqrt((g * g).sum(0))
    return g / np.maximum(norm, 1e-12)[None, :]


def surface_sites(r_max, centre, dx_min, p, rng, refine_iters=3):
    """(3, n) detected sites on the zero level set: cells within a
    diagonal of the surface are split until their pitch is ``dx_min``,
    a band of one cell is kept, jittered in the cell, projected by
    Newton steps along the gradient and thinned with probability
    ``p``."""
    h = max(2.0 * r_max / 24.0, dx_min)
    ax = np.arange(-r_max + h / 2, r_max, h)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=0) \
        + centre[:, None]
    pts = pts[:, np.abs(sdf(pts)) < h * np.sqrt(3.0)]
    offs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], dtype=float).T
    while h > dx_min:
        h = max(h / 2.0, dx_min)
        pts = (pts[:, :, None] + (offs * (h / 2.0))[:, None, :]) \
            .reshape(3, -1)
        pts = pts[:, np.abs(sdf(pts)) < h * np.sqrt(3.0)]
    pts = pts[:, np.abs(sdf(pts)) < dx_min / 2.0]
    pts = pts + rng.uniform(-dx_min / 2.0, dx_min / 2.0, size=pts.shape)
    delta = max(0.1 * dx_min, 1e-3)
    for _ in range(refine_iters):
        pts = pts - sdf(pts)[None, :] * _normals(pts, delta)
    return pts[:, rng.uniform(size=pts.shape[1]) < p]


def loc_error(shape, psf_width, mean_photon_count, bg_photon_count, rng):
    """Per-localization sigma of the photon model: the PSF's sigma over
    the square root of bg + Exponential(mean) photons."""
    n, d = shape
    widths = np.broadcast_to(np.atleast_1d(np.asarray(psf_width, float)),
                             (d,))
    photons = bg_photon_count + rng.exponential(mean_photon_count,
                                                size=(n, d))
    return (widths[None, :] / 2.355) / np.sqrt(photons)


def smlmify(points, sigma, rng, **photon):
    """Each localization replaced by one of ``CLUSTER`` Gaussian
    re-detections of the cloud, drawn without replacement, with fresh
    sigmas."""
    redetect = np.vstack([rng.normal(points, sigma)
                          for _ in range(CLUSTER)])
    pick = rng.choice(np.arange(redetect.shape[0]), size=points.shape[0],
                      replace=False)
    redetect = redetect[pick]
    return redetect, loc_error(redetect.shape, rng=rng, **photon)


def acquisition64(seed, psf_width, mean_photon_count, bg_photon_count,
                  density, p, noise_fraction):
    """(points (N, 3), sigma (N, 3)) in float64, as the port draws
    them."""
    rng = np.random.default_rng(seed)
    photon = dict(psf_width=psf_width, mean_photon_count=mean_photon_count,
                  bg_photon_count=bg_photon_count)
    r_max, centre = bounds()
    sites = surface_sites(r_max, centre, (1.0 / density) ** (1.0 / 3.0), p,
                          rng).T
    sigma = loc_error(sites.shape, rng=rng, **photon)
    sites = sites + sigma * rng.standard_normal(sigma.shape)
    cap, cap_sigma = smlmify(sites, sigma, rng, **photon)
    lo = BOX_SCALE * cap.min(0)
    hi = BOX_SCALE * cap.max(0)
    n_bg = int(noise_fraction * len(cap) / (1.0 - noise_fraction))
    bg = rng.uniform(size=(n_bg, 3)) * (hi - lo)[None, :] + lo[None, :]
    bg_sigma = loc_error(bg.shape, rng=rng, **photon)
    bg, bg_sigma = smlmify(bg, bg_sigma, rng, **photon)
    return np.vstack([cap, bg]), np.vstack([cap_sigma, bg_sigma])


def ersim_cloud(cloud, seed):
    """(points (N, 3) f32, sigma (N, 3) f32) of the configuration's
    ``cloud`` settings."""
    pts, sigma = acquisition64(seed, **{k: v for k, v in cloud.items()
                                        if k != 'shape'})
    return pts.astype(np.float32), sigma.astype(np.float32)
