"""remesh_engine_s (program_span; layer: host topology engine): FitTrace
kind ``remesh/engine``, the ``native.remesh`` call of the scheduled
remeshes, seconds a fit."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'host topology engine: native/topology.cpp remesh'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'remesh/engine'))
