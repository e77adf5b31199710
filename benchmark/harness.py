"""One run of one cell: set-up, the measured window, the traced fit, the
check and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
configuration's file (its ``file`` key), the workload's fit schedule
(``workloads/<traffic>.json``), the cell's correctness limits
(``limits/<cell>.json``), the kind of fit (``fits/<config fit>.py``),
the true shape the final surface is held to
(``reference/shapes/<config cloud shape>.py``) and each metric's reader
(``metrics/<metric>.py``).  Adding a cell, a configuration, a shape or
a metric adds files and manifest entries and edits none of these.
"""

import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ch_shrinkwrap_tpu')


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A cell's manifest entry with its configuration, workload, limits,
    true shape and metrics, read from the files the manifest names.
    ``overrides`` replaces keys of the configuration (``config``), the
    workload (``workload``) and the limits (``limits``), for runs at a
    size a test can hold."""

    def __init__(self, name, root=ROOT, manifest=None, overrides=None):
        self.manifest = manifest or load_json(
            os.path.join(root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.manifest['workloads']}
        if name not in cells:
            raise SystemExit(f'unknown workload {name!r}; the manifest has '
                             f'{sorted(cells)}')
        self.name = name
        self.dir = os.path.join(root, 'benchmark')
        self.entry = cells[name]
        cfg = {c['name']: c for c in self.manifest['configs']}[
            self.entry['config']]
        self.config = load_json(os.path.join(root, cfg['file']))
        self.workload = load_json(os.path.join(
            self.dir, 'workloads', self.entry['traffic'] + '.json'))
        self.limits = load_json(os.path.join(self.dir, 'limits',
                                             name + '.json'))
        for key, val in (overrides or {}).items():
            getattr(self, key).update(val)
        self.shape = shape_module(self.config['cloud']['shape'], self.dir)
        # every cell reports every end-to-end metric, and the per-layer
        # metrics that list it
        self.e2e = list(self.manifest['end_to_end'])
        self.per_layer = [m for m in self.manifest['per_layer']
                          if name in m['workloads']]


def _module(bench_dir, package, name):
    """The module of ``<package>/<name>.py`` under ``bench_dir``."""
    path = os.path.join(bench_dir, *package.split('.'), name + '.py')
    mod_name = f'benchmark.{package}.' + name.replace('.', '_') \
        .replace('-', '_')
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(metric_name, bench_dir=HERE):
    """The module of ``metrics/<metric_name>.py``: ``read(run)``, and
    ``SOURCE`` and ``LAYER``."""
    return _module(bench_dir, 'metrics', metric_name)


def shape_module(shape_name, bench_dir=HERE):
    """The module of ``reference/shapes/<shape_name>.py``:
    ``gap(vertices, cloud)``, the final surface's distance in nm from
    the true shape."""
    d = os.path.join(bench_dir, 'reference', 'shapes')
    if not os.path.isfile(os.path.join(d, shape_name + '.py')):
        known = sorted(f[:-3] for f in os.listdir(d)
                       if f.endswith('.py') and not f.startswith('_'))
        raise SystemExit(f'unknown shape {shape_name!r}; '
                         f'reference/shapes has {known}')
    return _module(bench_dir, 'reference.shapes', shape_name)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'nvidia-smi gave nothing'


def fit_record(wall, spans, mesh):
    """What the span metrics read from one fit: its wall, the
    benchmark's own spans and the port's ``FitTrace`` seconds."""
    kinds, block = {}, {'sort_s': 0.0, 'pad_s': 0.0, 'tables_s': 0.0,
                        'block_s': 0.0}
    for r in mesh.trace.records:
        kinds[r.kind] = kinds.get(r.kind, 0.0) + r.wall_time
        if r.kind == 'cg_block':
            for k in block:
                block[k] += r.extra.get(k, 0.0)
    return dict(wall=wall, spans=dict(spans), kinds=kinds, **block)


class Run:
    """What the metric readers read."""

    def __init__(self, cell, setup_s):
        self.cell = cell
        self.setup_s = setup_s
        self.window_s = None
        self.fits = []
        self.profile = None        # devtrace.reduce() of the traced fit
        self.calls = []            # (family, bound_s) of the traced fit


def run_cell(name, seed, seconds, trace, device='cuda', t_start=None,
             root=ROOT, manifest=None, overrides=None, control=False,
             log=None):
    """Runs one cell and returns the result line's dict; ``overrides``
    as :class:`Cell` takes them."""
    import torch
    from . import check, devtrace
    from .instrument import Spans
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = Cell(name, root, manifest, overrides)
    torch.manual_seed(seed)

    def sync():
        if device != 'cpu':
            torch.cuda.synchronize()
    spans = Spans()
    spans.install()
    try:
        fit_mod = importlib.import_module(
            'benchmark.fits.' + cell.config['fit'])
        fit = fit_mod.Fit(cell.config, cell.workload, seed, device, spans)
        # warm-up: the cell's own settings up to its first surgery
        # boundary, so every kernel, the small solve and the host engine
        # have run once
        spans.new_fit()
        fit(max_iter=cell.workload['warm_iterations'])
        sync()
        spans.capture = set(check.sample_blocks(cell.workload, seed))
        gc.collect()
        fits, t_w0 = [], time.perf_counter()
        run = Run(cell, t_w0 - t_start)
        mesh, attempted, failed = None, 0, 0
        while True:
            spans.new_fit()
            mesh = None
            t0 = time.perf_counter()
            attempted += 1
            try:
                mesh = fit()
                sync()
            except (RuntimeError, FloatingPointError, ValueError) as e:
                failed += 1
                log(f'fit {attempted} failed: {e!r}')
                break
            t1 = time.perf_counter()
            fits.append(fit_record(t1 - t0, spans.spans, mesh))
            log(f'fit {attempted}: {t1 - t0:.4f} s, V={len(mesh.vertices)}')
            if t1 - t_w0 >= seconds:
                break
        run.window_s = time.perf_counter() - t_w0
        run.fits = fits
        captured = dict(blocks=spans.captured, start=spans.start,
                        necks=spans.necks)
        if trace and not failed:
            spans.capture = set()
            spans.calls = []
            spans.new_fit()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device != 'cpu':
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function('bench.fit'):
                    traced = fit()
                    sync()
            run.calls = spans.calls
            spans.calls = None
            run.profile = devtrace.reduce(prof) if device != 'cpu' else None
            del prof, traced
    finally:
        spans.uninstall()
    dev_info = dict(platform='cpu', kind='cpu', count=0,
                    memory_peak_bytes=0)
    if device != 'cpu':
        dev_info = dict(platform='gpu',
                        kind=torch.cuda.get_device_name(0), count=1,
                        memory_peak_bytes=int(
                            torch.cuda.max_memory_allocated()))
        log(f'card: {card_line()}; memory peak '
            f'{dev_info["memory_peak_bytes"]} bytes')
    if run.profile is not None:
        dev_info['busy_s'] = run.profile['busy_s']
        dev_info['window_s'] = run.profile['window_s']
        log(f'trace: {run.profile["n_device_events"]} device events, '
            f'{run.profile["n_ranges"]} kernel-wrapper ranges; '
            f'family seconds {run.profile["family_s"]}')
    # the check, once the window has closed and the fit objects are gone
    final, inputs = mesh, fit.inputs
    fit = mesh = None
    gc.collect()
    if device != 'cpu':
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    numbers = check.compare(captured, final, cell.config, cell.workload,
                            inputs, seed, cell.shape, control=control,
                            log=log) \
        if not failed else dict.fromkeys(check.NUMBERS, float('inf'))
    log(f'check took {time.perf_counter() - t_c:.2f} s')
    correct = not failed and all(
        numbers[k] <= cell.limits[k] for k in check.NUMBERS)
    metrics = {}
    wanted = cell.per_layer if trace else cell.e2e
    for m in wanted:
        value = metric_module(m['name'], cell.dir).read(run)
        if value is not None:
            metrics[m['name']] = dict(value=value, unit=m['unit'])
    result = dict(correct=bool(correct), attempted=attempted, failed=failed,
                  metrics=metrics, device=dev_info)
    if run.profile is not None:
        result['breakdown'] = dict(device_ops=run.profile['device_ops'],
                                   idle_gaps=run.profile['idle_gaps'])
    walls = [f['wall'] for f in fits]
    if walls:
        log(f'fits in the window: {len(walls)}, wall median '
            f'{statistics.median(walls):.4f} s, first {walls[0]:.4f} s; '
            f'set-up {run.setup_s:.4f} s')
    for k in check.NUMBERS:
        log(f'{k} {numbers[k]!r} limit {cell.limits[k]!r}')
    # a number that could not be formed (no state captured, a failed
    # fit) reads as null in the line, and as not correct
    result['compared'] = {k: dict(value=numbers[k] if np.isfinite(numbers[k])
                                  else None, limit=cell.limits[k])
                          for k in check.NUMBERS}
    return result
