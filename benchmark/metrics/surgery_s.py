"""surgery_s (program_span; layer: surgery, MembraneMesh.remove_necks
and models.holepunch): FitTrace kinds ``remove_necks`` and
``punch_holes``, seconds a fit; nothing for a fit without surgery."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'surgery: MembraneMesh.remove_necks, models.holepunch'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'remove_necks',
                                             'punch_holes'))
