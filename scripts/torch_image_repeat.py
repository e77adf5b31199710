"""Run chip_smoke.py's image phase several times and report every
boundary step that breaks the surface.

    python3 scripts/torch_image_repeat.py [--runs 5] [--device cuda]
        [--snapshots DIR]
    python3 scripts/torch_image_repeat.py --device cpu --runs 1 \
        --n-points 3000 --radius 60 --grid-n 12 --iters 12 \
        --min-edge 8 --voxel 4          # a tiny CPU run

The image recipe fit (ImageShrinkwrapMembrane with the shrink prior on
a 5 nm histogram of the 1e6-point sphere cloud) differs from run to run
on the card in the order of its atomic sums, so a fault of the topology
surgery may show in some runs only.  Each call of ``remove_necks``,
``remove_extra_short_edges`` and ``remesh`` during the fits is checked:
a step that turns a manifold surface non-manifold, or raises the
component count, prints a ``BREAK`` line (and, with ``--snapshots``,
saves the mesh it started from as ``.npz``, so the step can be rerun on
the CPU).  Each run ends with one JSON line of its result; the last
line counts the runs whose final surface is one closed manifold
component.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from ch_shrinkwrap_torch.models import membrane_mesh  # noqa: E402

STEPS = ('remove_necks', 'remove_extra_short_edges', 'remesh')


def topology(mesh):
    _, n_comp = mesh.connected_components()
    return dict(V=int(mesh.vertices.shape[0]),
                euler=int(mesh.euler_characteristic),
                manifold=bool(mesh.is_manifold), components=int(n_comp))


def watch_steps(state, snapshots):
    """Wrap the surgery steps of MembraneMesh with the check."""
    for name in STEPS:
        step = getattr(membrane_mesh.MembraneMesh, name)

        def checked(self, *args, _step=step, _name=name, **kwargs):
            before = topology(self)
            v, f = self.vertices.copy(), self.faces.copy()
            out = _step(self, *args, **kwargs)
            after = topology(self)
            if ((before['manifold'] and not after['manifold'])
                    or after['components'] > before['components']):
                state['breaks'] += 1
                rec = dict(run=state['run'], step=_name, before=before,
                           after=after, args=repr(args))
                print('BREAK', json.dumps(rec), flush=True)
                if snapshots:
                    np.savez_compressed(os.path.join(
                        snapshots, f"run{state['run']}_{state['breaks']}_"
                        f"{_name}.npz"), vertices=v, faces=f)
            return out

        setattr(membrane_mesh.MembraneMesh, name, checked)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--runs', type=int, default=5)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--snapshots', default=None,
                    help='directory for the .npz meshes before a break')
    ap.add_argument('--n-points', type=int, default=chip_smoke.N_POINTS)
    ap.add_argument('--radius', type=float, default=chip_smoke.RADIUS)
    ap.add_argument('--grid-n', type=int, default=48)
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--min-edge', type=float, default=5.0)
    ap.add_argument('--voxel', type=float, default=chip_smoke.VOXEL)
    args = ap.parse_args(argv)
    if args.snapshots:
        os.makedirs(args.snapshots, exist_ok=True)
    state = {'run': 0, 'breaks': 0}
    watch_steps(state, args.snapshots)
    intact = 0
    for run in range(args.runs):
        state['run'] = run
        t0 = time.time()
        fit = chip_smoke.phase_image(
            args.device, n_points=args.n_points, radius=args.radius,
            grid_n=args.grid_n, iters=args.iters, min_edge=args.min_edge,
            voxel=args.voxel)
        ok = fit['euler'] == 2 and fit['manifold'] \
            and fit['components'] == 1
        intact += ok
        print(json.dumps(dict(
            run=run, seconds=time.time() - t0, intact=ok,
            **{k: fit[k] for k in ('fit_s', 'host_share', 'R_mean',
                                   'R_std', 'V', 'euler', 'manifold',
                                   'components', 'necks_removed')})),
              flush=True)
    print(json.dumps(dict(runs=args.runs, intact=intact,
                          breaks=state['breaks'])), flush=True)


if __name__ == '__main__':
    main()
