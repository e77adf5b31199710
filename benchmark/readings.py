"""The numbers that decide ``correct``, read on many seeds of one cell
in one process, for setting a cell's limits (``limits/<cell>.json``).

    python3 benchmark/readings.py --workload points1m.northstar \
        --seeds 11 12 13 [--control | --fault no_remesh]

Each seed is a run of the cell with a window of one fit (set-up, that
fit, the check), and prints one JSON line: the seed, each number, the
fit's wall and whether the run was correct under the cell's limits.
``--control`` puts the bfloat16 reference in the program's place;
``--fault`` plants one of ``benchmark.faults`` under the timed path.
The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--control', action='store_true')
    ap.add_argument('--fault', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(cache, 'triton'))
    os.environ.setdefault('CUDA_CACHE_PATH', os.path.join(cache, 'nv'))
    sys.path.insert(0, ROOT)
    from benchmark import faults, harness
    undo = faults.plant(args.fault) if args.fault else None
    try:
        for seed in args.seeds:
            lines = []
            r = harness.run_cell(args.workload, seed, 0.001, 0,
                                 device=args.device, control=args.control,
                                 log=lambda *a: lines.append(
                                     ' '.join(map(str, a))))
            for line in lines:
                print(line, file=sys.stderr)
            print(json.dumps(dict(
                seed=seed, fault=args.fault, control=args.control,
                correct=r['correct'], failed=r['failed'],
                numbers={k: v['value'] for k, v in r['compared'].items()},
                fit_s=r['metrics']['fit_s']['value'])), flush=True)
    finally:
        if undo:
            undo()
    return 0


if __name__ == '__main__':
    sys.exit(main())
