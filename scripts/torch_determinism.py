"""List the operations of the 20-iteration fit that torch calls
nondeterministic.

    python3 scripts/torch_determinism.py                  # on the card
    python3 scripts/torch_determinism.py --device cpu --n-points 4000

Runs ``chip_smoke.phase_fit`` (the 20-iteration no-surgery fit of the
1e6-point R = 500 nm sphere cloud from its marching-cubes seed) once
under ``torch.use_deterministic_algorithms(True, warn_only=True)`` and
prints one JSON line for each distinct warning torch raised about an
operation without a deterministic implementation (the first line of
the message and how often it came), then a JSON line with the count,
the device and the fit's result and digests.  A diagnostic, not part
of the fit: the package never sets the flag.  Under the flag torch
also swaps some operations for slower deterministic ones without a
warning (``index_add_``, ``index_put_`` with ``accumulate``), so the
fit's wall here is not the fit's wall.
"""

import argparse
import collections
import json
import os
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--n-points', type=int, default=chip_smoke.N_POINTS)
    ap.add_argument('--iters', type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if args.device.startswith('cuda') and not torch.cuda.is_available():
        print('torch_determinism: no CUDA device', file=sys.stderr)
        return 2
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            fit = chip_smoke.phase_fit(device=args.device,
                                       n_points=args.n_points,
                                       iters=args.iters)
    finally:
        torch.use_deterministic_algorithms(prev)
    ops = collections.Counter(
        str(w.message).strip().splitlines()[0] for w in caught
        if 'determinis' in str(w.message))
    for msg, n in ops.most_common():
        print(json.dumps({'warning': msg, 'count': n}), flush=True)
    dev = torch.device(args.device)
    print(json.dumps({
        'nondeterministic_ops': len(ops),
        'device': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                   else 'cpu'),
        **{k: fit[k] for k in ('fit_s', 'V', 'R_mean', 'R_std', 'euler',
                               'sha_vertices', 'sha_faces')}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
