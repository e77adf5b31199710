"""The benchmark of ch_shrinkwrap_torch: one run of one cell.

    python3 benchmark/run.py --workload points1m.northstar --seed 7 \
        --seconds 45 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card.  The
run draws its cloud from ``--seed``, warms up, times whole fits back to
back for ``--seconds`` (the fit in progress at the end finishes and
counts), with ``--trace 1`` profiles one more fit, checks the timed
path's state against the plain reference, and prints one JSON line as
the last line of standard output.  It exits non-zero, printing no
result, without a card, or when a JAX module was loaded.  The control
and the planted faults of the check are read by ``benchmark/readings.py``.

Build and kernel caches stay inside the checkout: the port's own
(``ch_shrinkwrap_torch/_build/``, ``ch_shrinkwrap_torch/native/``) and
``.bench_cache/`` for CUDA's and Triton's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache = os.path.join(ROOT, '.bench_cache')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(cache, 'nv')
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.Cell(args.workload)
    import torch
    chips = int(cell.entry['chips'])
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f'needs {chips} CUDA device(s); torch sees {seen}',
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              args.trace, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f'JAX modules were loaded: {bad}', file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
