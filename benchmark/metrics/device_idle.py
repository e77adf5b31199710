"""device_idle (device_trace; layer: device): 100 x (1 - the union of
the traced fit's device events over the fit's wall), in %."""

SOURCE = 'device_trace'
LAYER = 'device'


def read(run):
    p = run.profile
    if p is None or p['window_s'] <= 0 or p['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
