"""Small math / noise-model helpers.

Capability parity with the reference `ch_shrinkwrap/util.py` (see
ch_shrinkwrap/util.py:4-47), re-implemented vectorized:
the reference's rejection-sampled truncated exponential photon counts are
replaced by the exact memoryless-property equivalent (bg + Exp(mean)),
and all randomness flows through an explicit ``numpy.random.Generator``.
Also ``fma_f32``, the float32 fused multiply-add of the device code,
written in plain torch ops.
"""

from __future__ import annotations

import numpy as np
import torch


def fast_3x3_cross(a, b):
    """Cross product for length-3 vectors (reference util.py:4)."""
    x = a[1] * b[2] - a[2] * b[1]
    y = a[2] * b[0] - a[0] * b[2]
    z = a[0] * b[1] - a[1] * b[0]
    return np.array([x, y, z])


def fast_sum(vec):
    return vec[0] + vec[1] + vec[2]


def dot2(v):
    """Squared norm (reference util.py:22)."""
    return (v * v).sum()


def _rng(rng) -> np.random.Generator:
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return rng


def loc_error(shape, model=None, psf_width=250.0, mean_photon_count=300.0,
              bg_photon_count=20.0, rng=None, **kw):
    """Per-localization sigma from the SMLM photon-count error model.

    sigma = (psf_width / 2.355) / sqrt(N) with N ~ Exponential(mean)
    conditioned on N > bg_photon_count.  The reference draws 10x samples
    and filters (util.py:37-47); by the memoryless property of the
    exponential the conditional law is exactly bg + Exponential(mean),
    which we draw directly.

    Parameters
    ----------
    shape : tuple
        (n_points, n_dims) output shape.
    model : str or None
        'exponential' for the photon model; anything else returns the
        reference's 10 nm fallback.
    psf_width : float or sequence of float
        PSF FWHM per dimension (nm).
    """
    if model != 'exponential':
        return 10.0 * np.ones(shape)

    rng = _rng(rng)
    n, d = shape
    widths = np.broadcast_to(np.atleast_1d(np.asarray(psf_width, dtype=float)), (d,))
    photons = bg_photon_count + rng.exponential(mean_photon_count, size=(n, d))
    return (widths[None, :] / 2.355) / np.sqrt(photons)


def fma_f32(a, b, c):
    """``fma(a, b, c)`` of float32 tensors, rounded once to float32, as
    the CUDA kernels' ``__fmaf_rn`` and XLA's FMA chains round it.

    The float64 product of two float32 values is exact; their float64
    sum is rounded to odd before it is rounded to float32: TwoSum gives
    the sum's rounding error, and when the error is non-zero and the
    sum's last bit is even, the sum steps one ulp toward the exact
    value.  Rounding that to float32 is correct, because 53 >= 2 * 24 + 2
    (Boldo & Melquiond, "Emulation of FMA and correctly rounded sums:
    proved algorithms using rounding to odd", IEEE Trans. Computers,
    2008).  Elementwise torch ops only, the same on either device, and
    no read-back to the host."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    inf = s.new_tensor(float('inf'))
    odd = torch.nextafter(s, torch.where(err > 0, inf, -inf))
    return torch.where((err != 0) & even, odd, s).float()
