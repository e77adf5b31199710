"""End-to-end NanoWrap fit at the north-star scale, on the PyTorch port.

    python3 scripts/torch_e2e_fit.py                 # on the CUDA card
    python3 scripts/torch_e2e_fit.py --device cpu    # plain versions

The defaults are the north-star workload of the JAX package's
``scripts/e2e_fit.py`` (BASELINE.json): 1e6 localizations on an
R = 500 nm sphere with sigma = 5 nm, 99 iterations, remesh every 5,
neck removal from iteration 9 at thresholds -1e-3 / 1e-2, hole punching
every 13 with a minimum hole radius of 100 nm, and a minimum edge of
5 nm, from the ``wrap_start(offset=25, grid_n=48)`` seed.  The lighter
no-surgery fit is ``--iters 20 --punch-frequency 0 --neck-first-iter -1``.

Prints the fit line and the per-phase trace (the top-level spans) as
the JAX script does, then one JSON line: seed and fit seconds, vertex count, mean radius
and its spread, Euler characteristic, manifoldness, component count,
the trace's wall totals by kind (with the CG blocks' host rebuild split
into sort, pad and tables), and the card's name and power limit; with
``--profile``, the device's busy seconds and its idle seconds by the
port's span.  The
compile prewarm of the JAX script has no counterpart here, and
capacity modes other than 'final' are not ported (they raise).
"""
import argparse
import bisect
import contextlib
import json
import logging
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument('--iters', type=int, default=99)
ap.add_argument('--n-points', type=int, default=1_000_000)
ap.add_argument('--sigma', type=float, default=5.0)
ap.add_argument('--radius', type=float, default=500.0)
ap.add_argument('--curvature-weight', type=float, default=20.0)
ap.add_argument('--remesh-frequency', type=int, default=5)
ap.add_argument('--punch-frequency', type=int, default=13,
                help='delaunay/punch cadence; 0 disables')
ap.add_argument('--min-hole-radius', type=float, default=100.0)
ap.add_argument('--neck-first-iter', type=int, default=9,
                help='-1 disables neck removal')
ap.add_argument('--neck-threshold-low', type=float, default=-1e-3)
ap.add_argument('--neck-threshold-high', type=float, default=1e-2)
ap.add_argument('--minimum-edge-length', type=float, default=5.0)
ap.add_argument('--capacity-mode', choices=['final', 'two', 'bucketed'],
                default='final',
                help="only 'final' (one padded capacity for the whole "
                     "fit) is ported")
ap.add_argument('--grid-n', type=int, default=48,
                help='marching grid of the wrap_start seed')
ap.add_argument('--device', default='cuda')
ap.add_argument('--profile', action='store_true',
                help='run the fit under torch.profiler and add the summed '
                     'device time of its kernels, copies and fills '
                     '(device_busy_s) and its idle seconds by the port\'s '
                     'innermost span (idle_by_span) to the JSON line; the '
                     'profiler slows the host, so read the wall from a run '
                     'without it')


def card():
    """The card's name and power limit as nvidia-smi prints them, or
    None without one."""
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def device_busy_s(prof):
    """Seconds the profiled window kept the device busy: the summed
    duration of its device events (kernels, copies, fills; one stream,
    so they do not overlap)."""
    from torch.autograd import DeviceType
    return sum(e.time_range.end - e.time_range.start
               for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6


def idle_by_span(prof, trace, t0_ns, t1_ns):
    """Seconds between ``t0_ns`` and ``t1_ns`` (Unix ns) in which the
    device ran nothing, summed by the kind of the port's innermost span
    open at each instant (``FitTrace.span_at``); ``untraced`` where
    none was."""
    busy = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if 'CUDA' in str(e.device_type()) and e.duration_ns() > 0)
    # a gap splits where a span starts or ends
    edges = sorted({t for r in trace.records for t in (r.start_ns, r.end_ns)})
    out, prev = {}, t0_ns
    for s, e in busy + [(t1_ns, t1_ns)]:
        s, e = max(s, t0_ns), min(e, t1_ns)
        if s > prev:
            cuts = [prev] + edges[bisect.bisect_right(edges, prev):
                                  bisect.bisect_left(edges, s)] + [s]
            for a, b in zip(cuts, cuts[1:]):
                rec = trace.span_at((a + b) // 2)
                kind = 'untraced' if rec is None else rec.kind
                out[kind] = out.get(kind, 0.0) + (b - a) / 1e9
        prev = max(prev, e)
    return out


def main():
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    import torch
    from ch_shrinkwrap_torch.mesh.marching import wrap_start
    from ch_shrinkwrap_torch.models import MembraneMesh
    from ch_shrinkwrap_torch.utils.tracing import device_profile

    rng = np.random.default_rng(0)
    R, sigma, N = args.radius, args.sigma, args.n_points
    d = rng.normal(size=(N, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * R + rng.normal(scale=sigma, size=(N, 3))).astype(np.float32)
    sig = np.full((N, 3), sigma, np.float32)

    t_all = time.time()
    surf = wrap_start(pts, offset=25.0, grid_n=args.grid_n,
                      device=args.device)
    t_seed = time.time() - t_all
    print(f"wrap_start: {t_seed:.1f}s  V={surf.vertices.shape[0]}",
          flush=True)

    mesh = MembraneMesh(
        mesh=surf, kc=1.0, step_size=args.curvature_weight,
        max_iter=args.iters, remesh_frequency=args.remesh_frequency,
        delaunay_remesh_frequency=args.punch_frequency,
        delaunay_eps=args.min_hole_radius,
        neck_first_iter=args.neck_first_iter,
        neck_threshold_low=args.neck_threshold_low,
        neck_threshold_high=args.neck_threshold_high, device=args.device)
    mesh.capacity_mode = args.capacity_mode
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(device_profile()) if args.profile \
            else None
        t0, t0_ns = time.time(), time.time_ns()
        mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                         minimum_edge_length=args.minimum_edge_length)
        if mesh.device.type == 'cuda':
            torch.cuda.synchronize()
        t_fit, t1_ns = time.time() - t0, time.time_ns()
    r = np.linalg.norm(mesh.vertices, axis=1)
    labels, n_comp = mesh.connected_components()
    print(f"fit: {t_fit:.1f}s  total(e2e): {time.time() - t_all:.1f}s  "
          f"V={mesh.vertices.shape[0]} "
          f"R={r.mean():.2f}+/-{r.std():.2f}  "
          f"euler={mesh.euler_characteristic} manifold={mesh.is_manifold} "
          f"components={n_comp}", flush=True)
    if n_comp > 1:
        for c in range(n_comp):
            m = labels == c
            rv = np.linalg.norm(mesh.vertices[m], axis=1)
            print(f"  component {c}: V={int(m.sum())} "
                  f"r=[{rv.min():.1f},{rv.max():.1f}]", flush=True)
    for rec in mesh.trace.records:
        if rec.parent is None:
            print(rec.kind, rec.iteration, f"{rec.wall_time:.1f}s",
                  f"V={rec.n_vertices}", flush=True)
    print(json.dumps({
        'seed_s': t_seed, 'fit_s': t_fit,
        'V': int(mesh.vertices.shape[0]), 'R_mean': float(r.mean()),
        'R_std': float(r.std()), 'euler': int(mesh.euler_characteristic),
        'manifold': bool(mesh.is_manifold), 'components': int(n_comp),
        'n_punched': int(sum(rec.extra.get('n_punched', 0)
                             for rec in mesh.trace.records)),
        'wall': mesh.trace.wall_by_phase(), 'device': str(mesh.device),
        'device_busy_s': device_busy_s(prof) if prof is not None else None,
        'idle_by_span': idle_by_span(prof, mesh.trace, t0_ns, t1_ns)
        if prof is not None else None,
        'card': card() if mesh.device.type == 'cuda' else None}),
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
