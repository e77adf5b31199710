"""Chosen entries of the sweep grids through the JAX package on the CPU,
the reference beside the port's rows of ``scripts/torch_grids.py``.

    JAX_PLATFORMS=cpu python3 scripts/jax_grid_entries.py \\
        configs/test_necks_separator_recipe.yaml --entry dbb18cee3208 \\
        --out eval_out_torch/reruns/jax_cpu

Each ``--entry HASH`` (the harness's entry hash, which both packages
compute alike) runs through ``ch_shrinkwrap_tpu.eval.harness.
run_shrinkwrap_entry`` with seed 0, as the JAX package's ``evaluate``
runs it; the row goes to ``<out>/<save_fp>/metrics.jsonl``, and one JSON
line a config reports it beside its newest record, as
``scripts/torch_grids.py`` does.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'scripts'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('configs', nargs='+')
    ap.add_argument('--entry', action='append', required=True)
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)

    import jax
    jax.config.update('jax_platforms', 'cpu')
    from ch_shrinkwrap_tpu.eval.harness import run_shrinkwrap_entry
    import torch_grids

    records = torch_grids.load_records()
    only = set(args.entry)
    for config in args.configs:
        save_fp, entries = torch_grids.grid_entries(config)
        os.makedirs(os.path.join(args.out, save_fp), exist_ok=True)
        log = {}
        for h, p in entries:
            if h not in only:
                continue
            t0 = time.time()
            metrics, _ = run_shrinkwrap_entry(dict(p), rng=0)
            log[h] = dict(status='ok', wall_s=time.time() - t0)
            rec = {'kind': 'shrinkwrap', 'param_hash': h,
                   'params': {k: str(v) for k, v in p.items()}, **metrics}
            with open(os.path.join(args.out, save_fp, 'metrics.jsonl'),
                      'a') as fh:
                fh.write(json.dumps(rec) + '\n')
        print(json.dumps(torch_grids.grid_report(
            config, args.out, log, records, 'cpu (JAX package)', only)),
            flush=True)


if __name__ == '__main__':
    main()
