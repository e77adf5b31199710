"""update_s (program_span; layer: host state after a block): FitTrace
kind ``cg_block/update``, from the positions on the host to the end of
the block's record (``set_positions``, the curvature cache, the
record), seconds a fit."""

from benchmark.metrics._common import kinds, mean_per_fit

SOURCE = 'program_span'
LAYER = ('host state after a block: set_positions, curvature cache, the '
         'trace record')


def read(run):
    return mean_per_fit(run, lambda f: kinds(f, 'cg_block/update'))
