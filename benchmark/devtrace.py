"""Reduction of the profiled fit's trace to device numbers.

From ``torch.profiler``'s raw events of one fit:

* the device events (kernels, copies, fills), their union (busy
  seconds) and the idle gaps between them inside the fit's own span;
* the device ranges of the benchmark's ``bench.*`` spans: the profiler
  mirrors each host annotation on the device timeline, over the work
  launched inside it, so a kernel belongs to the innermost range that
  holds its midpoint, however long after its launch it ran;
* the device seconds of the kernel families K1, K2, K2s and K3 (K3 and
  K3f together): every device event of their wrapper calls;
* the ten device operations that took most time and the ten longest
  idle gaps, each gap named by the innermost host span open at its
  midpoint.
"""

import bisect

FAMILY = {'bench.k1': 'k1', 'bench.k2': 'k2', 'bench.k2s': 'k2s',
          'bench.k3': 'k3', 'bench.k3f': 'k3'}


def _is_device(ev):
    return 'CUDA' in str(ev.device_type())


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Spans:
    """(start, end, name) intervals, queried for the innermost one that
    holds a time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]
        self.longest = max((e - s for s, e, _ in self.spans), default=0)

    def at(self, t):
        best = None
        i = bisect.bisect_right(self.starts, t)
        lo = bisect.bisect_left(self.starts, t - self.longest)
        for s, e, name in self.spans[lo:i]:
            if s <= t <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return None if best is None else best[2]


def reduce(prof, fit_span='bench.fit'):
    """Returns a dict: ``window_s``, ``busy_s``, ``family_s`` {family:
    device seconds}, ``device_ops`` [[name, s]], ``idle_gaps``
    [[name, s]], or None when the trace holds no fit span."""
    host, ranges, device = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        iv = (ev.start_ns(), ev.start_ns() + ev.duration_ns(), name)
        if not name.startswith('bench.'):
            if _is_device(ev) and ev.duration_ns() > 0:
                device.append(iv)
        elif _is_device(ev):
            ranges.append(iv)
        else:
            host.append(iv)
    fit = [(s, e) for s, e, n in host if n == fit_span]
    if not fit:
        return None
    f0, f1 = fit[-1]
    host = Spans([h for h in host if h[2] != fit_span
                  and h[0] >= f0 and h[1] <= f1])
    ranges = Spans([r for r in ranges if r[2] in FAMILY])
    device = [d for d in device if f0 <= d[0] <= f1]
    family_s, by_op = {}, {}
    for s, e, name in device:
        by_op[name] = by_op.get(name, 0) + (e - s)
        fam = FAMILY.get(ranges.at((s + e) / 2))
        if fam is not None:
            family_s[fam] = family_s.get(fam, 0.0) + (e - s) / 1e9
    merged = _merge([(s, e) for s, e, _ in device])
    busy = sum(e - s for s, e in merged) / 1e9
    gaps, prev = [], f0
    for s, e in merged + [[f1, f1]]:
        if s > prev:
            gaps.append((s - prev, host.at((s + prev) / 2) or fit_span))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(f1 - f0) / 1e9, busy_s=busy, family_s=family_s,
                device_ops=[[n, d / 1e9] for n, d in ops],
                idle_gaps=[[n[len('bench.'):], d / 1e9]
                           for d, n in gaps[:10]],
                n_device_events=len(device), n_ranges=len(ranges.spans))
