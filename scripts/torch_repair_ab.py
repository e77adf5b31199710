"""The neck pass's removal and repair: the numpy passes against the
native call, bit for bit and timed, on the inputs a whole fit hands them.

For each benchmark cell named (default: the north star and the image
recipe, the two cells with a neck pass), one fit of the cell's own
configuration and workload runs (``benchmark.fits``, the seed given),
and every ``MembraneMesh.remove_necks`` call's ``repair`` input (the
mesh and the vertices it removes) is kept.  Then each input runs
through both paths in turns (numpy, native, native, numpy, ...
``--repeats`` pairs): ``TriangleMesh._repair_numpy`` and
``TriangleMesh.repair`` (the native call), and their
vertices, faces and counts must be equal.  One JSON line an input: the
mesh sizes, the vertices removed, each path's median seconds and the
repair's counts; one line a cell sums them, beside the fit's own
``remove_necks/repair`` spans.

    python3 scripts/torch_repair_ab.py [--cells CELL ...] [--seed N]
        [--repeats N] [--device cuda] [--n-points N] [--iterations N]

``--n-points`` and ``--iterations`` cut the cell for a run on the CPU
(``--device cpu``); the card runs it as the cell is.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from benchmark.harness import Cell  # noqa: E402
from benchmark.instrument import Spans  # noqa: E402
from ch_shrinkwrap_torch.mesh.core import TriangleMesh  # noqa: E402
from ch_shrinkwrap_torch.models import MembraneMesh  # noqa: E402


def neck_inputs(cell_name, seed, device, n_points=None, iterations=None):
    """One fit of the cell; returns the (vertices, faces, removed) of
    every neck pass's repair and the fit's ``remove_necks/repair``
    span seconds."""
    import importlib
    cell = Cell(cell_name)
    if n_points:
        cell.config['cloud']['n_points'] = n_points
    fit_mod = importlib.import_module('benchmark.fits.'
                                      + cell.config['fit'])
    fit = fit_mod.Fit(cell.config, cell.workload, seed, device, Spans())
    kept = []
    necks, repair = MembraneMesh.remove_necks, MembraneMesh.repair
    state = {'in_necks': False}

    def in_necks(self, *a, **k):
        state['in_necks'] = True
        try:
            return necks(self, *a, **k)
        finally:
            state['in_necks'] = False

    def keep(self, *a, **k):
        if state['in_necks'] and k.get('remove') is not None:
            kept.append((self.vertices.copy(), self.faces.copy(),
                         np.asarray(k['remove']).copy()))
        return repair(self, *a, **k)
    MembraneMesh.remove_necks, MembraneMesh.repair = in_necks, keep
    try:
        mesh = fit(max_iter=iterations)
    finally:
        MembraneMesh.remove_necks, MembraneMesh.repair = necks, repair
    spans = [r.wall_time for r in mesh.trace.records
             if r.kind == 'remove_necks/repair']
    return kept, spans


def time_both(v, f, rem, repeats):
    """Median seconds of each path, in turns; asserts equal bits."""
    times = {'numpy': [], 'native': []}
    out = {}
    for i in range(repeats):
        order = ('numpy', 'native') if i % 2 == 0 else ('native', 'numpy')
        for path in order:
            m = TriangleMesh(v.copy(), f.copy())
            t0 = time.perf_counter()
            counts = (m._repair_numpy(remove=rem) if path == 'numpy'
                      else m.repair(remove=rem))
            times[path].append(time.perf_counter() - t0)
            out[path] = (m.vertices, m.faces, counts)
    a, b = out['numpy'], out['native']
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and a[2] == b[2]):
        raise AssertionError('native repair differs from the numpy passes')
    return ({k: statistics.median(t) for k, t in times.items()}, b[2])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--cells', nargs='+',
                    default=['points1m.northstar', 'image5nm.recipe'])
    ap.add_argument('--seed', type=int, default=2147490101)
    ap.add_argument('--repeats', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--n-points', type=int, default=None)
    ap.add_argument('--iterations', type=int, default=None)
    args = ap.parse_args()
    import torch
    torch.manual_seed(args.seed)
    for name in args.cells:
        t0 = time.perf_counter()
        kept, spans = neck_inputs(name, args.seed, args.device,
                                  args.n_points, args.iterations)
        fit_s = time.perf_counter() - t0
        tot = {'numpy': 0.0, 'native': 0.0}
        for i, (v, f, rem) in enumerate(kept):
            med, counts = time_both(v, f, rem, args.repeats)
            for k in tot:
                tot[k] += med[k]
            print(json.dumps({'cell': name, 'call': i, 'V': len(v),
                              'F': len(f), 'removed': int(len(rem)),
                              'numpy_s': med['numpy'],
                              'native_s': med['native'],
                              'equal': True, **counts}), flush=True)
        print(json.dumps({
            'cell': name, 'seed': args.seed, 'calls': len(kept),
            'fit_s': fit_s, 'numpy_s': tot['numpy'],
            'native_s': tot['native'],
            'native_share': tot['native'] / tot['numpy'] if kept else None,
            'fit_repair_spans_s': sum(spans)}), flush=True)


if __name__ == '__main__':
    main()
