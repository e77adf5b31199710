"""k3_roofline (device_trace; layer: gathers, ops.cuda_gather K3
row_gather and K3f row_group_sum): the least time of every gather of
the traced fit (table, indices and mask read once, rows written once,
at the HBM rate) over the device time of their kernels, in %."""

from benchmark.metrics._common import roofline

SOURCE = 'device_trace'
LAYER = 'gathers: ops.cuda_gather'


def read(run):
    return roofline(run, 'k3')
