"""Structured fit tracing.

A fit reports into one ``FitTrace``: every span the port opens (the
seed, the model's construction, the set-up before the loop, each CG
block and topology pass, and their parts) closes into a ``SpanRecord``
with its path of open span names, its start and end on the clock of
``torch.profiler``'s events, its parent, and the fit's iteration.  The
records of a CG block also hold its residual norms and orthogonality
tests.  ``span_at`` finds the span open at a profiler timestamp, and
``dump_jsonl`` writes the records out.  ``device_profile`` wraps a
region in ``torch.profiler`` tracing.

The port's spans never open a ``torch.profiler.record_function``: the
trace stays on the host, and the profiler's device timeline holds only
the work the program launched.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time

import numpy as np
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(eq=False)
class SpanRecord:
    kind: str                   # open span names joined by '/'
    start_ns: int               # Unix ns, as torch.profiler's events
    parent: Optional['SpanRecord'] = None
    end_ns: int = 0
    iteration: int = 0          # the fit's outer iteration at close
    wall_time: float = 0.0      # (end_ns - start_ns) / 1e9
    n_vertices: Optional[int] = None
    n_faces: Optional[int] = None
    tests: Optional[list] = None
    ress: Optional[list] = None
    extra: dict = field(default_factory=dict)

    def observe(self, mesh, diag=None):
        """Notes the mesh's size and, for a CG block, its diagnostics'
        orthogonality tests and residual norms."""
        self.n_vertices = int(mesh.vertices.shape[0])
        self.n_faces = int(mesh.faces.shape[0])
        if diag is not None:
            self.tests = np.asarray(diag.tests.cpu()).astype(float).tolist()
            self.ress = np.asarray(diag.ress.cpu()).astype(float).tolist()


class FitTrace:
    """The spans of a fit, in the order they closed (a parent after its
    children).  ``j`` is the fit's outer iteration, which the fit loop
    keeps current."""

    def __init__(self, records=None, offset_ns=None):
        self.records: List[SpanRecord] = list(records or ())
        # perf_counter_ns is monotonic; one offset, fixed here, puts it
        # on the Unix clock the profiler's events report
        self.offset_ns = (time.time_ns() - time.perf_counter_ns()
                          if offset_ns is None else offset_ns)
        self.j = 0
        self._open = []
        self._index = None

    def continued(self):
        """A new trace that holds this one's records, on its clock."""
        return FitTrace(self.records, self.offset_ns)

    def now_ns(self):
        return time.perf_counter_ns() + self.offset_ns

    @contextlib.contextmanager
    def span(self, name, **extra):
        """Times the block inside as a span named ``name`` under the
        spans open around it; yields its record, whose ``extra`` starts
        as ``extra``."""
        parent = self._open[-1] if self._open else None
        rec = SpanRecord(name if parent is None else
                         parent.kind + '/' + name, self.now_ns(), parent,
                         extra=extra)
        self._open.append(rec)
        try:
            yield rec
        finally:
            rec.end_ns = self.now_ns()
            self._open.pop()
            rec.iteration = self.j
            rec.wall_time = (rec.end_ns - rec.start_ns) / 1e9
            self.records.append(rec)

    def span_at(self, t_ns):
        """The innermost recorded span open at ``t_ns`` (Unix ns, as a
        profiler event's ``start_ns()``), or None."""
        if self._index is None or self._index[0] != len(self.records):
            # spans nest, so the innermost one that holds a time is the
            # one holding it that started last
            recs = sorted(self.records,
                          key=lambda r: (r.start_ns, r.kind.count('/')))
            longest = max((r.end_ns - r.start_ns for r in recs), default=0)
            self._index = (len(recs), recs, [r.start_ns for r in recs],
                           longest)
        _, recs, starts, longest = self._index
        i = bisect.bisect_right(starts, t_ns)
        while i > 0 and starts[i - 1] >= t_ns - longest:
            i -= 1
            if recs[i].end_ns >= t_ns:
                return recs[i]
        return None

    def summary(self):
        by_kind = {}
        for r in self.records:
            by_kind.setdefault(r.kind, [0, 0.0])
            by_kind[r.kind][0] += 1
            by_kind[r.kind][1] += r.wall_time
        return {k: {'count': c, 'seconds': round(s, 3)}
                for k, (c, s) in by_kind.items()}

    def wall_by_phase(self):
        """Wall seconds by kind, plus the CG blocks' host rebuild
        (``sort``, ``pad``, ``tables``) and the blocks' own time
        (``block``: from the call to the positions back on the host,
        the curvature cache reset and seeded), summed from the cg_block
        records."""
        out = {k: v['seconds'] for k, v in self.summary().items()}
        for key in ('sort_s', 'pad_s', 'tables_s', 'block_s'):
            out[key[:-2]] = round(sum(r.extra.get(key, 0.0)
                                      for r in self.records
                                      if r.kind == 'cg_block'), 3)
        return out

    def dump_jsonl(self, path):
        """One JSON line a record; ``parent`` is the line number (from
        0) of the parent's record, or null."""
        line = {id(r): i for i, r in enumerate(self.records)}
        with open(path, 'w') as fh:
            for r in self.records:
                fh.write(json.dumps({
                    'kind': r.kind, 'iteration': r.iteration,
                    'wall_time': r.wall_time, 'start_ns': r.start_ns,
                    'end_ns': r.end_ns,
                    'parent': None if r.parent is None
                    else line.get(id(r.parent)),
                    'n_vertices': r.n_vertices, 'n_faces': r.n_faces,
                    'tests': r.tests, 'ress': r.ress, **r.extra}) + '\n')


def span(obj, name, **extra):
    """``obj.trace.span(name, **extra)``, or a null context (yielding
    None) when ``obj`` carries no trace."""
    trace = getattr(obj, 'trace', None)
    if trace is None:
        return contextlib.nullcontext()
    return trace.span(name, **extra)


@contextlib.contextmanager
def device_profile(out_dir=None):
    """Profile a region with ``torch.profiler`` (CPU and, where present,
    CUDA activities) and yield the profiler; its ``key_averages()``
    gives time by kernel.  With ``out_dir`` the Chrome trace is written
    to ``out_dir/trace.json``."""
    import os
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, 'trace.json'))
