"""seed_field_s (program_span; layer: seed field): FitTrace kind
``seed/march/field``, the seed's ``native.knn_field`` call, seconds a
fit."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'seed field: native.knn_field'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'seed/march/field'))
