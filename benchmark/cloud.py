"""The benchmark's inputs, drawn from the seed.

A frozen copy of ``chip_smoke.sphere_cloud``: the cloud is n
localizations on a sphere with isotropic Gaussian error.  Both sides of
the correctness check get these arrays.
"""

import numpy as np


def sphere_cloud(n, radius, sigma, seed):
    """(points (n, 3) f32, sigma (n, 3) f32) from a numpy generator."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * radius + rng.normal(scale=sigma, size=(n, 3))
           ).astype(np.float32)
    return pts, np.full((n, 3), sigma, np.float32)
