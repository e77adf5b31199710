"""A true shape's reductions on the port's own sweep entries, read on the
card, for choosing the reduction of a shape module's ``gap`` and, with
a cell of that shape, its ``shape_gap`` limit.

    python3 benchmark/sweep_readings.py --config configs/test_ersim.yaml \
        --shape ersim --seeds 0 1 2 --trace-seed 3

For each seed the port's ``eval.harness.run_shrinkwrap_entry`` runs the
sweep's first shrinkwrap entry (simulation, density seed, fit, scoring)
and two surfaces are read against ``reference/shapes/<shape>.py``: the
seed surface ``initial_surface_from_density`` hands the fit, which a fit
that does nothing would keep ("unchanged"), and the finished fit
("sound").  For each, the RMS, mean and median over its used vertices
of |SDF|, and the module's own ``gap``; beside them the entry's own
metrics.  One JSON line a seed.

``--trace-seed`` runs one more entry with the benchmark's kernel
wrappers installed and ``torch.profiler`` on its fit, and prints the
fit's kernel rooflines (K1, K2, K2s, K3: ``metrics/<name>.py`` on
``counts.bounds``), its device idle share and its K2s launches.  The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ('k1_roofline', 'k2_roofline', 'k2s_roofline', 'k3_roofline',
           'device_idle')


def reductions(vertices, faces, truth):
    """{rms, mean, median, gap} of |SDF| over the used vertices, nm."""
    import numpy as np
    import torch
    used = torch.from_numpy(np.asarray(vertices, np.float64)[
        np.unique(np.asarray(faces))])
    d = truth.sdf(used).abs()
    return dict(n_vertices=int(used.shape[0]),
                rms=float(torch.sqrt((d ** 2).mean())),
                mean=float(d.mean()), median=float(d.median()),
                gap=truth.gap(used, {}))


def entry(params, seed, device, profile_fit=False):
    """(metrics, seed surface (vertices, faces), cloud size, fitted
    mesh, profiler or None) of one sweep entry."""
    import contextlib
    import torch
    from ch_shrinkwrap_torch.eval import harness as sweep
    from ch_shrinkwrap_torch.mesh import marching
    from ch_shrinkwrap_torch.models.membrane_mesh import MembraneMesh
    seen = {}
    density_seed, fit = marching.initial_surface_from_density, \
        MembraneMesh.shrink_wrap

    def keep_seed(points, *a, **k):
        surf = density_seed(points, *a, **k)
        seen.update(n_points=len(points), vertices=surf.vertices.copy(),
                    faces=surf.faces.copy())
        return surf

    def traced_fit(self, *a, **k):
        with torch.profiler.record_function('bench.fit'):
            out = fit(self, *a, **k)
            torch.cuda.synchronize()
        return out
    marching.initial_surface_from_density = keep_seed
    if profile_fit:
        MembraneMesh.shrink_wrap = traced_fit
    prof = None
    try:
        ctx = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile_fit \
            else contextlib.nullcontext()
        with ctx as prof:
            metrics, mesh = sweep.run_shrinkwrap_entry(params, rng=seed,
                                                       device=device)
    finally:
        marching.initial_surface_from_density = density_seed
        MembraneMesh.shrink_wrap = fit
    return metrics, (seen['vertices'], seen['faces']), seen['n_points'], \
        mesh, prof


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', required=True)
    ap.add_argument('--shape', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--trace-seed', type=int, default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import yaml
    from benchmark import devtrace, harness
    from benchmark.instrument import Spans
    from ch_shrinkwrap_torch.eval.harness import testing_parameters
    truth = harness.shape_module(args.shape)
    with open(args.config) as fh:
        params = testing_parameters(yaml.safe_load(fh))[0][0]
    for seed in args.seeds:
        metrics, (sv, sf), n, mesh, _ = entry(params, seed, args.device)
        print(json.dumps(dict(
            seed=seed, n_points=n, shape=args.shape,
            unchanged=reductions(sv, sf, truth),
            sound=reductions(mesh.vertices, mesh.faces, truth),
            entry={k: metrics.get(k) for k in (
                'duration', 'ntriangles', 'euler', 'components',
                'manifold', 'sdf_rms', 'sdf_mean_abs', 'sdf_p99',
                'sdf_hausdorff')})), flush=True)
    if args.trace_seed is None:
        return 0
    spans = Spans()
    spans.install()
    try:
        spans.calls = []
        _, _, n, mesh, prof = entry(params, args.trace_seed, args.device,
                                    profile_fit=True)
        calls = spans.calls
    finally:
        spans.uninstall()
    run = harness.Run(None, 0.0)
    run.profile, run.calls = devtrace.reduce(prof), calls
    out = {name: harness.metric_module(name).read(run) for name in READERS}
    print(json.dumps(dict(
        seed=args.trace_seed, n_points=n, traced=out,
        k2s_calls=sum(1 for f, _ in calls if f == 'k2s'),
        k2s_bound_s=sum(b for f, b in calls if f == 'k2s'),
        family_s=run.profile['family_s'], busy_s=run.profile['busy_s'],
        window_s=run.profile['window_s'],
        device_ops=run.profile['device_ops'],
        idle_gaps=run.profile['idle_gaps'],
        n_faces=int(len(mesh.faces)))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
