"""k1_roofline (device_trace; layer: K1, ops.cuda_window and
csrc/window.cu): the least time of every K1 call of the traced fit (7
operations a pair the windowed search examines, at the FP32 peak) over
the device time of the kernels those calls launched, in %."""

from benchmark.metrics._common import roofline

SOURCE = 'device_trace'
LAYER = 'K1: ops.cuda_window, csrc/window.cu'


def read(run):
    return roofline(run, 'k1')
