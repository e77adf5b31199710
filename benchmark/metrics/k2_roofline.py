"""k2_roofline (device_trace; layer: K2, ops.cuda_scatter and
csrc/scatter.cu): the least time of every K2 call of the traced fit
(its rows read once and its face sums written once, at the HBM rate)
over the device time of every kernel those calls launched (route,
histograms, scans, scatters, offsets, reduce), in %."""

from benchmark.metrics._common import roofline

SOURCE = 'device_trace'
LAYER = 'K2: ops.cuda_scatter, csrc/scatter.cu'


def read(run):
    return roofline(run, 'k2')
