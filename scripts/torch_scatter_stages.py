"""Device time of each stage of K2 and K2s (``csrc/scatter.cu``) on the
fit path's own inputs, for one or more widths of the radix ordering's
digits.

    python3 scripts/torch_scatter_stages.py [--bits-max 10 8 7]

The inputs are ``chip_smoke.path_inputs``'s (the sorted 1e6-point cloud
over a remeshed R = 500 sphere): K2 in 'ah' mode on K1's rows and on
``chip_smoke.adversarial_rows`` (44,839 rows on one subsample face), and
K2s on the vertex normals' corner rows and on the brute-force search's
(N, 12) A^T rows.  For each width the host's digit plan
(``cuda_scatter.digit_plan``) takes passes of at most that many bits;
every case is first held to its plain version on a CPU copy (equal
bits), then timed with ``chip_smoke.device_stages``.  Prints the card's
name and power limit, then one JSON line per width and case: the
stages' ms a call (histogram, scan, scatter, offsets, reduce), all the
call's device work and its number of device events.  Needs one CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def cases(cs, inp):
    """name -> (call, stage names, plain version's output on a CPU
    copy) of each case."""
    from ch_shrinkwrap_torch.ops import cuda_scatter, normals
    ma = inp.ma
    corners = normals.vertex_normal_corners(
        ma.positions, ma.faces, ma.f_mask).reshape(-1, 3)
    faces_t = ma.faces.reshape(-1)
    ah_rows = cuda_scatter._columns('ah', inp.w, inp.res, None)
    out = {}
    for name, fid in (('K2.path', inp.fid),
                      ('K2.adversarial', cs.adversarial_rows(inp))):
        args = ('ah', inp.w, inp.res, None, fid, inp.js, inp.meta_starts,
                inp.sub_ids, inp.Fp)
        out[name] = (lambda a=args: cuda_scatter.windowed_scatter(*a),
                     cs.K2_STAGES,
                     cuda_scatter.windowed_scatter_plain(*cs.to_cpu(args)))
    for name, (rows, tgt, S) in (('K2s.normals', (corners, faces_t,
                                                  inp.Vp)),
                                 ('K2s.brute_ah', (ah_rows, inp.fid,
                                                   inp.Fp))):
        out[name] = (lambda a=(rows, tgt, S):
                     cuda_scatter.segment_sum_ordered(*a),
                     cs.K2S_STAGES,
                     cuda_scatter.segment_sum_ordered_plain(
                         *cs.to_cpu((rows, tgt, S))))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--bits-max', type=int, nargs='+', default=[10])
    a = ap.parse_args()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30, check=True)
    print(smi.stdout.strip(), flush=True)
    import torch
    import chip_smoke as cs
    from ch_shrinkwrap_torch.ops import cuda_scatter
    torch.backends.cuda.matmul.allow_tf32 = False
    inp = cs.path_inputs()
    todo = cases(cs, inp)
    rc = 0
    for bits in a.bits_max:
        cuda_scatter.RADIX_BITS_MAX = bits
        for name, (fn, stages, ref) in todo.items():
            n_bits = cs.bits_differ(fn(), ref)
            rc = rc or int(n_bits != 0)
            st = cs.device_stages(fn, stages, reps=10)
            print(json.dumps({'bits_max': bits, 'case': name,
                              'plan': cuda_scatter.digit_plan(
                                  inp.Fp if name.startswith('K2.')
                                  or name == 'K2s.brute_ah' else inp.Vp),
                              'bits_differ': n_bits, **st}), flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
