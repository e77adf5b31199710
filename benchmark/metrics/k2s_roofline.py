"""k2s_roofline (device_trace; layer: K2s, ops.cuda_scatter
segment_sum_ordered and csrc/scatter.cu): the least time of every K2s
call of the traced fit (its rows, targets and initial table read once
and its segments written once, at the HBM rate) over the device time of
every kernel those calls launched (key histogram, radix scans and
scatters, offsets, reduce), in %.  None where the fit launches no K2s,
as a fit on the windowed search does."""

from benchmark.metrics._common import roofline

SOURCE = 'device_trace'
LAYER = 'K2s: ops.cuda_scatter.segment_sum_ordered, csrc/scatter.cu'


def read(run):
    return roofline(run, 'k2s')
