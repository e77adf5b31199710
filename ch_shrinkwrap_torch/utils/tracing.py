"""Structured fit tracing.

Every CG block and topology pass of a fit reports into a ``FitTrace``:
per-block records (residual norm, orthogonality test, vertex and face
counts, area, wall-clock) that can be dumped as JSONL.  ``device_profile``
wraps a region in ``torch.profiler`` tracing.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class BlockRecord:
    kind: str                   # 'cg_block' | 'remesh' | 'punch_holes' | ...
    iteration: int              # outer iteration index at block end
    wall_time: float
    n_vertices: int
    n_faces: int
    area: float
    tests: Optional[list] = None
    ress: Optional[list] = None
    extra: dict = field(default_factory=dict)


@dataclass
class FitTrace:
    records: List[BlockRecord] = field(default_factory=list)
    t_start: float = field(default_factory=time.time)

    def record(self, kind, iteration, wall_time, mesh, diag=None, **extra):
        # area is observability, not control flow: only computed when
        # the mesh's cache is warm or the mesh is small (-1.0 = not
        # computed), since a fresh face-geometry pass costs real time
        # at 300k faces
        if (getattr(mesh, '_face_areas_cache', None) is not None
                or mesh.faces.shape[0] <= 100_000):
            area = float(mesh.area())
        else:
            area = -1.0
        rec = BlockRecord(
            kind=kind, iteration=iteration, wall_time=wall_time,
            n_vertices=int(mesh.vertices.shape[0]),
            n_faces=int(mesh.faces.shape[0]),
            area=area,
            tests=None if diag is None else
            np.asarray(diag.tests.cpu()).astype(float).tolist(),
            ress=None if diag is None else
            np.asarray(diag.ress.cpu()).astype(float).tolist(),
            extra=extra)
        self.records.append(rec)
        return rec

    @property
    def total_time(self):
        return time.time() - self.t_start

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
        (``block``: from the call to the positions back on the host),
        summed from the cg_block records."""
        out = {k: v['seconds'] for k, v in self.summary().items()}
        for key in ('sort_s', 'pad_s', 'tables_s', 'block_s'):
            out[key[:-2]] = round(sum(r.extra.get(key, 0.0)
                                      for r in self.records
                                      if r.kind == 'cg_block'), 3)
        return out

    def dump_jsonl(self, path):
        with open(path, 'w') as fh:
            for r in self.records:
                fh.write(json.dumps({
                    'kind': r.kind, 'iteration': r.iteration,
                    'wall_time': r.wall_time,
                    'n_vertices': r.n_vertices, 'n_faces': r.n_faces,
                    'area': r.area, 'tests': r.tests, 'ress': r.ress,
                    **r.extra}) + '\n')


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
