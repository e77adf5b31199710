"""The repo's sweep grids (``configs/*.yaml``) through the port's
harness, each entry's topology held beside the JAX package's records.

    python3 scripts/torch_grids.py                      # all twelve, card
    python3 scripts/torch_grids.py configs/test_tetra.yaml --timeout 600
    python3 scripts/torch_grids.py configs/test_punch.yaml --device cpu \\
        --entry 0123456789ab --out eval_out_torch/reruns/port_cpu

Each config runs through ``ch_shrinkwrap_torch.eval.harness.evaluate``
(seed 0) in spawned workers that share the card, one entry a worker,
with ``--timeout`` seconds an entry; grids run side by side so that at
most ``--workers`` entries run at once.  The rows go to
``<out>/<save_fp>/metrics.jsonl`` (default ``eval_out_torch``), and a
restart skips the entries already there.  The kernels' launches are
counted inside each worker (``harness.kernel_launches``).  With
``--entry HASH`` (repeatable) only those entries run; ``--device cpu``
runs them on the plain versions (the CPU rerun of an entry whose
topology differs from its record).

The reference of an entry is the newest JAX record that agrees with it
on every parameter the two share (``eval_out*/metrics.jsonl`` of the
JAX package; the entry hashes cannot match, because the records
predate some keys and the hash covers every key).  A key that a record
lacks takes the harness's default (``neck_detector`` 'threshold',
``via_recipe`` and ``remesh_collapse_veto`` False), and the newest is
the highest ``_rN`` round in the directory's name (unsuffixed is 0).

Prints the card's name and power limit, then one JSON line a grid: its
entries, ``topology_correct`` here as k of n, the records' k of n over
the same entries, the entries whose (euler, components) differ from
their record or that did not finish, and per entry ``sdf_rms``,
``ntriangles``, ``duration`` (the fit's seconds, from the row), the
worker's seconds and the launches.  Exits non-zero only when an entry
failed other than by its timeout.
"""

import argparse
import ast
import glob
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time

import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from ch_shrinkwrap_torch.eval import harness  # noqa: E402

# keys added to the harness after the oldest records, at the value the
# records' code ran with
KEY_DEFAULTS = {'neck_detector': 'threshold', 'via_recipe': False,
                'remesh_collapse_veto': False}
TOPOLOGY = ('euler', 'components', 'manifold', 'topology_correct')


def _value(v):
    """A parameter as the records store it (``str(v)``) read back."""
    if not isinstance(v, str):
        v = str(v)
    try:
        v = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
    if isinstance(v, tuple):
        v = list(v)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    return v


def load_records(repo=REPO):
    """Every shrinkwrap row of the JAX package's ``eval_out*/`` records
    (not the port's ``eval_out_torch``), with its directory, round and
    parameters read back."""
    out = []
    for path in sorted(glob.glob(os.path.join(repo, 'eval_out*',
                                              'metrics.jsonl'))):
        d = os.path.basename(os.path.dirname(path))
        if d.startswith('eval_out_torch'):
            continue
        m = re.search(r'_r(\d+)', d)
        rnd = int(m.group(1)) if m else 0
        with open(path) as fh:
            for line in fh:
                row = json.loads(line)
                if row.get('kind') != 'shrinkwrap':
                    continue
                params = {**KEY_DEFAULTS,
                          **{k: _value(v) for k, v in row['params'].items()}}
                out.append(dict(dir=d, round=rnd, params=params, row=row))
    return out


def record_for(params, records):
    """The newest record that agrees with ``params`` on every shared
    key (None when none does)."""
    want = {k: _value(v) for k, v in params.items()}
    hits = [r for r in records
            if all(r['params'][k] == v for k, v in want.items()
                   if k in r['params'])]
    if not hits:
        return None
    return max(hits, key=lambda r: (r['round'], r['dir']))


def grid_entries(config):
    """(hash, params) of each shrinkwrap entry of a config, in the
    harness's order."""
    with open(config) as fh:
        test_d = yaml.safe_load(fh)
    sw, _ = harness.testing_parameters(test_d)
    return test_d.get('save_fp') or os.path.splitext(
        os.path.basename(config))[0], [
        (harness._param_hash({'kind': 'shrinkwrap', **p}), p) for p in sw]


def entry_label(params, entries):
    """The parameters that vary across a grid, as a short label."""
    keys = [k for k in params
            if len({str(p[k]) for _, p in entries}) > 1]
    return ' '.join(f'{k}={params[k]}' for k in keys) or 'single'


def read_rows(path):
    """Rows of a metrics file by entry hash (the last row wins)."""
    rows = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                row = json.loads(line)
                rows[row['param_hash']] = row
    return rows


def grid_report(config, out, log, records, device_name, only=None):
    """One grid's line (over the entries in ``only`` when given)."""
    save_fp, entries = grid_entries(config)
    if only:
        entries = [(h, p) for h, p in entries if h in only]
    rows = read_rows(os.path.join(out, save_fp, 'metrics.jsonl'))
    per_entry, differ = [], []
    for h, p in entries:
        row = rows.get(h)
        rec = record_for(p, records)
        info = log.get(h, {})
        e = dict(hash=h, label=entry_label(p, entries),
                 status='ok' if row else info.get('status', 'not run'),
                 wall_s=info.get('wall_s'), launches=info.get('launches'))
        if row:
            e.update({k: row.get(k) for k in TOPOLOGY + (
                'sdf_rms', 'ntriangles', 'duration')})
        if rec:
            e['record'] = dict(dir=rec['dir'], **{
                k: rec['row'].get(k) for k in TOPOLOGY + (
                    'sdf_rms', 'ntriangles')})
        if not row or (rec and (row['euler'], row['components'])
                       != (rec['row']['euler'], rec['row']['components'])):
            differ.append(h)
        per_entry.append(e)
    n = len(entries)
    recs = [e['record'] for e in per_entry if 'record' in e]
    return dict(
        grid=os.path.basename(config), save_fp=save_fp, device=device_name,
        entries=n,
        card=dict(k=sum(bool(e.get('topology_correct')) for e in per_entry),
                  n=n),
        jax_record=dict(k=sum(bool(r['topology_correct']) for r in recs),
                        n=len(recs), dirs=sorted({r['dir'] for r in recs})),
        differ=differ, per_entry=per_entry)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('configs', nargs='*',
                    help='sweep configs (default: configs/*.yaml)')
    ap.add_argument('--out', default=os.path.join(REPO, 'eval_out_torch'))
    ap.add_argument('--workers', type=int, default=6,
                    help='entries running at once over all grids')
    ap.add_argument('--timeout', type=float, default=1500.0,
                    help='seconds an entry, then it counts as timeout')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--entry', action='append', default=[],
                    help='run only this entry hash (repeatable)')
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    configs = args.configs or sorted(
        glob.glob(os.path.join(REPO, 'configs', '*.yaml')))
    records = load_records()

    device_name = args.device
    if args.device.startswith('cuda'):
        import torch
        if not torch.cuda.is_available():
            print('torch_grids: no CUDA device', file=sys.stderr)
            return 2
        device_name = torch.cuda.get_device_name(0)
        print(subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True,
            text=True).stdout.strip(), flush=True)
    # each worker gets its share of the host's cores
    threads = str(max(1, (os.cpu_count() or 1) // max(1, args.workers)))
    for var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ.setdefault(var, threads)

    only = set(args.entry) or None
    sizes = {c: sum(only is None or h in only for h, _ in grid_entries(c)[1])
             for c in configs}
    configs = [c for c in configs if sizes[c]]
    logs = {c: {} for c in configs}
    free = [args.workers]
    cv = threading.Condition()

    def one_grid(config, n):
        with cv:
            cv.wait_for(lambda: free[0] >= n)
            free[0] -= n
        try:
            save_fp, _ = grid_entries(config)
            harness.evaluate(config, out_dir=os.path.join(args.out, save_fp),
                             seed=0, n_workers=n, entry_timeout=args.timeout,
                             device=args.device, entry_log=logs[config],
                             only=only)
        except Exception:
            logging.exception('grid %s failed', config)
        finally:
            with cv:
                free[0] += n
                cv.notify_all()

    # the one-entry grids (the largest meshes) first; a grid of
    # several entries takes half the workers, so two run together
    pool = []
    for c in sorted(configs, key=sizes.get):
        t = threading.Thread(target=one_grid, args=(
            c, min(sizes[c], (args.workers + 1) // 2)))
        t.start()
        pool.append(t)
        time.sleep(0.5)
    for t in pool:
        t.join()
    rc = 0
    for c in configs:
        rep = grid_report(c, args.out, logs[c], records, device_name,
                          only)
        print(json.dumps(rep), flush=True)
        if any(e['status'] in ('error', 'died') for e in rep['per_entry']):
            rc = 1
    return rc


if __name__ == '__main__':
    sys.exit(main())
