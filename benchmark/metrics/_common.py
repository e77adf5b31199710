"""Shared arithmetic of the span and roofline readers."""


def mean_per_fit(run, value):
    """Mean over the window's fits of ``value(fit)``; None when no fit
    has the value."""
    vals = [value(f) for f in run.fits]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(vals) if vals else None


def kinds(fit, *names):
    """Seconds of the port's FitTrace records of the given kinds, or
    None when the fit has none of them."""
    found = [fit['kinds'][n] for n in names if n in fit['kinds']]
    return sum(found) if found else None


def roofline(run, family):
    """100 x the bound seconds over the device seconds of one kernel
    family in the traced fit, or None without a trace or a launch."""
    if run.profile is None:
        return None
    bound = sum(b for f, b in run.calls if f == family)
    device = run.profile['family_s'].get(family, 0.0)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
