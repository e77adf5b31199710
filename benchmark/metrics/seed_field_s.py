"""seed_field_s (program_span; layer: seed field): FitTrace kind
``seed/march/field``, the seed's bounded k-th-neighbour field, seconds a
fit: on a CUDA fit the card's ``ops.cuda_field.knn_field``
(``csrc/knn_field.cu``), on a CPU one the host engine's
``native.knn_field``."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'seed field: ops.cuda_field.knn_field, csrc/knn_field.cu'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'seed/march/field'))
