"""rebuild_s (program_span; layer: padding and tables, ops.meshdata with
the boundary sort): the cg_block records' sort_s + pad_s + tables_s,
seconds a fit."""

from benchmark.metrics._common import mean_per_fit

SOURCE = 'program_span'
LAYER = 'padding and tables: ops.meshdata'


def read(run):
    return mean_per_fit(run, lambda f: f['sort_s'] + f['pad_s']
                        + f['tables_s'] if 'cg_block' in f['kinds']
                        else None)
