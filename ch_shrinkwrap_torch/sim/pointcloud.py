"""SMLM point-cloud simulation.

Capability parity with the reference's simulation path
(the reference ch_shrinkwrap/evaluation_utils.py:182-282 and
PYME `simulation.locify.points_from_sdf`, which the reference imports
from PYME at shape.py:16).  ``points_from_sdf`` here is our own
implementation: hierarchical octree-style band refinement of the SDF
zero level set followed by Newton projection, instead of PYME's
sampler.  The observable contract is the same — approximately uniform
surface points at pitch ``dx_min``, detected with probability ``p``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from . import sdf as _sdf
from ..utils.math import loc_error, _rng


def points_from_sdf(sdf, r_max, centre=None, dx_min=1.0, p=0.1, rng=None,
                    refine_iters=3):
    """Sample approximately uniform points on the zero level set of ``sdf``.

    Parameters
    ----------
    sdf : callable
        Signed distance function taking (3, N) points.
    r_max : float
        Bounding radius of the shape about ``centre``.
    centre : (3,) array
        Centre of the bounding volume.
    dx_min : float
        Target sample pitch on the surface (nm).
    p : float
        Detection probability: each candidate surface site is kept
        independently with probability ``p``.
    rng : np.random.Generator | int | None
        Randomness source.

    Returns
    -------
    (3, N) array of points on the surface.
    """
    rng = _rng(rng)
    if centre is None:
        centre = np.zeros(3)
    centre = np.asarray(centre, dtype=float)

    # Hierarchical band refinement: keep only cells whose centre is
    # within a cell diagonal of the surface, split each survivor into 8
    # children, until the cell pitch reaches dx_min.
    h = 2.0 * r_max / 24.0
    if h < dx_min:
        h = dx_min
    ax = np.arange(-r_max + h / 2, r_max, h)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing='ij')
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=0) + centre[:, None]

    d = sdf(pts)
    keep = np.abs(d) < h * np.sqrt(3.0)
    pts = pts[:, keep]

    while h > dx_min:
        h_new = max(h / 2.0, dx_min)
        # 8 children per surviving cell at the new pitch
        offs = np.array([[sx, sy, sz] for sx in (-1, 1)
                         for sy in (-1, 1) for sz in (-1, 1)],
                        dtype=float).T * (h_new / 2.0)
        pts = (pts[:, :, None] + offs[:, None, :]).reshape(3, -1)
        d = sdf(pts)
        keep = np.abs(d) < h_new * np.sqrt(3.0)
        pts = pts[:, keep]
        h = h_new
        if pts.shape[1] == 0:
            return pts

    # Restrict to a band of one cell thickness so each dx_min^2 surface
    # patch contributes ~one candidate site.
    d = sdf(pts)
    keep = np.abs(d) < dx_min / 2.0
    pts = pts[:, keep]

    # Jitter within the cell to break the grid regularity, then Newton
    # projection onto the level set along the SDF gradient.
    pts = pts + rng.uniform(-dx_min / 2.0, dx_min / 2.0, size=pts.shape)
    delta = max(0.1 * dx_min, 1e-3)
    for _ in range(refine_iters):
        n = _sdf.sdf_normals(pts, sdf, delta=delta)
        pts = pts - sdf(pts)[None, :] * n

    # Monte-Carlo detection thinning.
    accept = rng.uniform(size=pts.shape[1]) < p
    return pts[:, accept]


def smlmify_points(points, sigma, psf_width=250.0, mean_photon_count=300,
                   bg_photon_count=20, max_points_per_cluster=10,
                   max_points=None, rng=None):
    """Resample each localization into a cluster of re-detections.

    Mirrors the reference (evaluation_utils.py:265-282): draw
    ``max_points_per_cluster`` Gaussian re-detections of every point,
    subsample back to the original count, and draw fresh per-point
    sigmas from the photon model.
    """
    rng = _rng(rng)
    noise_points = np.vstack([rng.normal(points, sigma)
                              for _ in range(max_points_per_cluster)])
    sz = points.shape[0] if max_points is None else max_points
    sel = rng.choice(np.arange(noise_points.shape[0]), size=sz, replace=False)
    noise_points = noise_points[sel]
    noise_sigma = loc_error(noise_points.shape, model='exponential',
                            psf_width=psf_width,
                            mean_photon_count=mean_photon_count,
                            bg_photon_count=bg_photon_count, rng=rng)
    return noise_points, noise_sigma


def generate_smlm_pointcloud_from_shape(
        shape_name: Union[str, object], shape_params: Optional[dict] = None,
        density: float = 1, p: float = 0.0001,
        psf_width: Union[float, Tuple, None] = 250.0,
        mean_photon_count: int = 300, bg_photon_count: float = 20.0,
        noise_fraction: float = 0.1, rng=None):
    """Simulate an SMLM acquisition of a named test shape.

    Mirrors the reference pipeline (evaluation_utils.py:182-263):
    surface sampling + photon-model jitter, cluster resampling, uniform
    background noise over a scaled bounding box, and SDF normals.

    Returns
    -------
    points : (N, 3), normals : (N, 3), sigma : (N, 3)
    """
    from . import shape as shape_mod

    rng = _rng(rng)
    if isinstance(shape_name, str):
        test_shape = getattr(shape_mod, shape_name)(**(shape_params or {}))
    else:
        test_shape = shape_name

    cap_points = test_shape.points(density=density, p=p, psf_width=psf_width,
                                   mean_photon_count=mean_photon_count,
                                   bg_photon_count=bg_photon_count,
                                   resample=True, rng=rng)
    cap_sigma = test_shape._sigma

    if psf_width is None:
        normals = _sdf.sdf_normals(cap_points.T, test_shape.sdf).T
        return cap_points, normals, cap_sigma

    cap_points, cap_sigma = smlmify_points(
        cap_points, cap_sigma, psf_width=psf_width,
        mean_photon_count=mean_photon_count,
        bg_photon_count=bg_photon_count, rng=rng)

    if noise_fraction > 0:
        no, scale = noise_fraction, 1.2
        bbox = [np.min(cap_points[:, 0]), np.min(cap_points[:, 1]),
                np.min(cap_points[:, 2]), np.max(cap_points[:, 0]),
                np.max(cap_points[:, 1]), np.max(cap_points[:, 2])]
        bbox = [scale * x for x in bbox]
        xl, yl, zl, xu, yu, zu = bbox
        xn, yn, zn = xu - xl, yu - yl, zu - zl
        ln = int(no * len(cap_points) / (1.0 - no))

        noise_points = (rng.uniform(size=(ln, 3)) * np.array([xn, yn, zn])[None, :]
                        + np.array([xl, yl, zl])[None, :])
        noise_sigma = loc_error(noise_points.shape, model='exponential',
                                psf_width=psf_width,
                                mean_photon_count=mean_photon_count,
                                bg_photon_count=bg_photon_count, rng=rng)
        noised_points, noised_sigma = smlmify_points(
            noise_points, noise_sigma, psf_width=psf_width,
            mean_photon_count=mean_photon_count,
            bg_photon_count=bg_photon_count, rng=rng)

        points = np.vstack([cap_points, noised_points])
        sigma = np.vstack([cap_sigma, noised_sigma])
    else:
        points = cap_points
        sigma = cap_sigma

    normals = _sdf.sdf_normals(points.T, test_shape.sdf).T
    return points, normals, sigma
