"""remesh_s (program_span; layer: host topology, mesh.remesh and
native/topology.cpp): FitTrace kinds ``remesh`` and ``short_edges``,
seconds a fit."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = 'host topology: mesh.remesh, native/topology.cpp'


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'remesh', 'short_edges'))
