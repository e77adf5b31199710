"""seed_s (program_span; layer: seed, mesh.marching.wrap_start): the
benchmark's span around ``wrap_start``, seconds a fit."""

from benchmark.metrics._common import mean_per_fit

SOURCE = 'program_span'
LAYER = 'seed: mesh.marching.wrap_start'


def read(run):
    return mean_per_fit(run, lambda f: f['spans'].get('seed'))
