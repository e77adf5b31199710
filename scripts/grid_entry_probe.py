"""One sweep-grid entry on the CPU through either package, for the
entries whose topology differs between runs, devices or packages.

    python3 scripts/grid_entry_probe.py fit {jax,torch} CONFIG HASH \\
        [--nudge SEED] [--threads N] [--save-necks DIR]
    python3 scripts/grid_entry_probe.py necks CONFIG HASH MESH.npz ...

``fit`` runs the entry (the harness's ``run_shrinkwrap_entry``, seed 0)
and prints one JSON line a surgery step (``remove_necks``,
``remove_extra_short_edges``, ``remesh``, ``punch_holes``) with the
vertex count, Euler number and components before and after, then the
final row's topology and ``sdf_rms``.  ``--nudge SEED`` moves every
coordinate of the density seed by one float32 ulp, up or down at
random (numpy seed SEED): a change below the rounding of any one CG
iteration, to show whether the entry's topology depends on it.
``--threads`` sets torch's CPU threads (the port's sums change order
with it); ``--jax-root DIR`` imports the JAX package from DIR (``git
archive COMMIT ch_shrinkwrap_tpu | tar -x -C DIR``, the code a record
was made with).  ``--save-necks DIR`` writes the mesh before each neck pass
to ``DIR/necks_<k>.npz``.

``necks`` loads each saved mesh into both packages with the entry's
neck parameters and runs one neck pass in each (no remesh after it):
the Gaussian curvature, the flagged vertices and the resulting
topology side by side.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'scripts'))


def entry_params(config, h):
    import torch_grids
    _, entries = torch_grids.grid_entries(config)
    hits = [p for hh, p in entries if hh == h]
    if not hits:
        raise SystemExit(f'{config} has no entry {h}')
    return dict(hits[0])


def use_jax_cpu():
    import jax
    jax.config.update('jax_platforms', 'cpu')


def snapshot(mesh):
    return dict(V=int(mesh.vertices.shape[0]),
                euler=int(mesh.euler_characteristic),
                components=int(mesh.connected_components()[1]))


def fit(args):
    params = entry_params(args.config, args.entry)
    if args.jax_root:
        sys.path.insert(0, os.path.abspath(args.jax_root))
    if args.package == 'jax':
        use_jax_cpu()
        from ch_shrinkwrap_tpu.eval import harness
        from ch_shrinkwrap_tpu.mesh import marching
        from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh
        kw = {}
    else:
        import torch
        if args.threads:
            torch.set_num_threads(args.threads)
        from ch_shrinkwrap_torch.eval import harness
        from ch_shrinkwrap_torch.mesh import marching
        from ch_shrinkwrap_torch.models.membrane_mesh import MembraneMesh
        kw = {'device': 'cpu'}

    seed_fn = marching.initial_surface_from_density

    def nudged_seed(*a, **k):
        surf = seed_fn(*a, **k)
        v = np.asarray(surf.vertices, np.float32)
        sign = np.random.default_rng(args.nudge).choice([-1.0, 1.0],
                                                        size=v.shape)
        far = (v + sign * np.abs(v).max()).astype(np.float32)
        surf.set_positions(np.nextafter(v, far))
        return surf

    if args.nudge is not None:
        marching.initial_surface_from_density = nudged_seed

    n_necks = [0]

    def logged(name):
        method = getattr(MembraneMesh, name)

        def run(self, *a, **k):
            if name == 'remove_necks' and args.save_necks:
                n_necks[0] += 1
                os.makedirs(args.save_necks, exist_ok=True)
                np.savez(os.path.join(args.save_necks,
                                      f'necks_{n_necks[0]}.npz'),
                         v=np.asarray(self.vertices),
                         f=np.asarray(self.faces))
            before = snapshot(self)
            out = method(self, *a, **k)
            print(json.dumps(dict(step=name, before=before,
                                  after=snapshot(self),
                                  returned=repr(out))), flush=True)
            return out
        setattr(MembraneMesh, name, run)

    for name in ('punch_holes', 'remove_necks', 'remove_extra_short_edges',
                 'remesh'):
        logged(name)
    t0 = time.time()
    metrics, _ = harness.run_shrinkwrap_entry(params, rng=0, **kw)
    print(json.dumps(dict(
        package=args.package, jax_root=args.jax_root,
        config=os.path.basename(args.config),
        entry=args.entry, nudge=args.nudge, threads=args.threads,
        wall_s=time.time() - t0,
        **{k: metrics.get(k) for k in (
            'euler', 'components', 'manifold', 'topology_correct',
            'ntriangles', 'sdf_rms')})), flush=True)


def necks(args):
    params = entry_params(args.config, args.entry)
    use_jax_cpu()
    from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JM
    from ch_shrinkwrap_torch.models.membrane_mesh import MembraneMesh as TM
    kw = dict(neck_detector=params.get('neck_detector', 'threshold'),
              neck_threshold_low=params['neck_threshold_low'],
              neck_threshold_high=params['neck_threshold_high'])
    for path in args.meshes:
        d = np.load(path)
        out = dict(mesh=os.path.basename(path))
        for tag, cls, extra in (('jax', JM, {}),
                                ('torch', TM, {'device': 'cpu'})):
            m = cls(vertices=d['v'].copy(), faces=d['f'].copy(),
                    **kw, **extra)
            K = np.asarray(m.curvature_gaussian)
            out[f'{tag}_K_sum'] = float(K.astype(np.float64).sum())
            before = snapshot(m)
            m.remove_necks(params['neck_threshold_low'],
                           params['neck_threshold_high'],
                           defer_remesh=True)
            out[tag] = dict(before=before, after=snapshot(m),
                            manifold=bool(m.is_manifold))
        print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest='mode', required=True)
    f = sub.add_parser('fit')
    f.add_argument('package', choices=['jax', 'torch'])
    f.add_argument('config')
    f.add_argument('entry')
    f.add_argument('--nudge', type=int, default=None)
    f.add_argument('--threads', type=int, default=None)
    f.add_argument('--save-necks', default=None)
    f.add_argument('--jax-root', default=None)
    n = sub.add_parser('necks')
    n.add_argument('config')
    n.add_argument('entry')
    n.add_argument('meshes', nargs='+')
    args = ap.parse_args(argv)
    fit(args) if args.mode == 'fit' else necks(args)


if __name__ == '__main__':
    main()
