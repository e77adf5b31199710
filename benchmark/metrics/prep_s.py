"""prep_s (program_span; layer: fit set-up): FitTrace kinds
``construct`` (``MembraneMesh.__init__``) and ``prep``
(``opt_conjugate_gradient`` from its entry to the loop), seconds a
fit."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = ('fit set-up: MembraneMesh construction and opt_conjugate_gradient '
         'before the loop')


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'construct', 'prep'))
