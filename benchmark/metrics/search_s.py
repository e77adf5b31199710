"""search_s (program_span; layer: nearest-face search, ops.correspondence
and solver.shrinkwrap.cg_block): the FitTrace kinds whose last name is
``search`` (inside the loop ``cg_block/block/search``, one a CG
iteration, around the call of the nearest-face search), seconds a fit.
None where the fit records no such span, as before the port had it.

The span is on the host's clock and synchronizes nothing, so it reads
the time the host spends issuing the search.  On the brute-force path
that is the search's whole cost: each search launches some 37,000 small
kernels (the float32 FMA emulation over 1024-point by 2048-face chunks),
the launches set the pace, and on the ERSim cell the span reads about
twice the device seconds of the kernels launched inside it (H100: 19.8 s
a fit against 10.8 s).  On a path of few launches (the windowed search's
K1) it reads only the launch time.
"""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'nearest-face search: ops.correspondence, solver.shrinkwrap.cg_block'


def _search(fit):
    return kinds(fit, *[k for k in fit['kinds']
                        if k.rsplit('/', 1)[-1] == 'search'])


def read(run):
    return mean_per_fit(run, _search)
