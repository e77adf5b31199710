"""block_s (program_span; layer: CG block, solver.shrinkwrap): the
cg_block records' block_s (from the call to the positions back on the
host), seconds a fit."""

from benchmark.metrics._common import mean_per_fit

SOURCE = 'program_span'
LAYER = 'CG block: solver.shrinkwrap'


def read(run):
    return mean_per_fit(run, lambda f: f['block_s'] if 'cg_block'
                        in f['kinds'] else None)
