"""Device times of the PyTorch port's kernels on the fit path's own
inputs, for one or more checkouts of this repository, each read in a
process of its own, in the order given.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...] [--k1-dump DIR]

ROOT is the root of a checkout: its ``ch_shrinkwrap_torch`` is imported
and its kernels are built.  The inputs and the timing come from this
checkout's ``chip_smoke.py`` (``path_inputs``, ``device_ms``), and
only the wrapper calls that every version of the port has are timed,
so two versions are read on the same footing.  To compare a change with
its parent on one card, give them in turns: parent, change, change,
parent.  ``--k1-dump DIR`` also writes, for each point where K1's kernel
and its plain version pick different faces, the point and its whole
candidate list (rows of the pre-scaled table, -2x, -2y, -2z, c2) to
``DIR/k1_disagree_<i>.npz``.

Prints the card's name and power limit, then one JSON line per ROOT.
Needs one CUDA device.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke_ab', os.path.join(HERE, 'chip_smoke.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_device_times(inp, timer, smoke):
    """Device time of each kernel wrapper call of one CG iteration on
    the path's inputs, through the calls every version of the port
    has: K1, K2 in 'ah' mode (all the call's device work: its kernels,
    and the zero fill or the ordering each version needs) on the path's
    rows and on ``chip_smoke.adversarial_rows``, K2s
    (``segment_sum_ordered``) on the vertex normals' corner rows, the tri / ncc / S gathers, and the whole
    faces -> vertices fold (``_fold`` with the gather tables)."""
    from ch_shrinkwrap_torch.ops import cuda_gather, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_window, normals
    from ch_shrinkwrap_torch.solver.shrinkwrap import _fold
    fid_adv = smoke.adversarial_rows(inp)
    out = {'K1': timer(lambda: cuda_window.window_min(*inp.k1_args),
                       match='window_min', reps=10),
           'K2': timer(lambda: cuda_scatter.windowed_scatter(
               'ah', inp.w, inp.res, None, inp.fid, inp.js,
               inp.meta_starts, inp.sub_ids, inp.Fp)),
           'K2.adversarial': timer(lambda: cuda_scatter.windowed_scatter(
               'ah', inp.w, inp.res, None, fid_adv, inp.js,
               inp.meta_starts, inp.sub_ids, inp.Fp), reps=5)}
    ma = inp.ma
    corners = normals.vertex_normal_corners(
        ma.positions, ma.faces, ma.f_mask).reshape(-1, 3)
    faces_t = ma.faces.reshape(-1)
    out['K2s.normals'] = timer(lambda: cuda_scatter.segment_sum_ordered(
        corners, faces_t, inp.Vp))
    for key, (src, idx) in inp.gathers.items():
        out['K3.' + key] = timer(lambda: cuda_gather.row_gather(src, idx),
                                 match='row_gather')
    out['fold'] = timer(lambda: _fold(inp.fused, inp.ma.faces, inp.Vp,
                                      inp.tables))
    return out


def k1_disagreements(inp, dump_dir):
    """Points whose face id or subsample slot differ between K1's
    kernel and its plain version, with their candidate lists saved."""
    import numpy as np
    import torch
    from ch_shrinkwrap_torch.ops import cuda_window
    d2k, fidk, jsk = inp.k1_out
    d2p, fidp, jsp = cuda_window.window_min_plain(*inp.k1_args)
    bad = ((fidk != fidp) | (jsk != jsp)).nonzero().tolist()
    blocks_t, starts, centers_t, c2, sub_ids, W, A = inp.k1_args
    starts_al, cand4, sub4, _ = cuda_window._pack(starts, centers_t, c2,
                                                  sub_ids, W)
    out = []
    for i, (b, t) in enumerate(bad[:8]):
        win = (starts_al[b].long()[:, None]
               + torch.arange(W, device=inp.dev)).reshape(-1)
        rec = dict(block=b, thread=t, fid_kernel=int(fidk[b, t]),
                   fid_plain=int(fidp[b, t]), js_kernel=int(jsk[b, t]),
                   js_plain=int(jsp[b, t]), d2_kernel=float(d2k[b, t]),
                   d2_plain=float(d2p[b, t]))
        out.append(rec)
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            np.savez(os.path.join(dump_dir, f'k1_disagree_{i}.npz'),
                     p=blocks_t[b, :, t].cpu().numpy(),
                     cand=torch.cat([cand4[win], sub4]).cpu().numpy(),
                     ids=torch.cat([win, sub_ids.long()]).cpu().numpy(),
                     **{k: np.asarray(v) for k, v in rec.items()})
    return len(bad), out


def child(root, dump_dir):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    import ch_shrinkwrap_torch
    inp = smoke.path_inputs()
    times = path_device_times(inp, smoke.device_ms, smoke)
    n_bad, bad = k1_disagreements(inp, dump_dir)
    print(json.dumps({'root': root,
                      'package': os.path.dirname(
                          ch_shrinkwrap_torch.__file__),
                      'Vp': inp.Vp, 'Fp': inp.Fp, 'N': inp.N,
                      'k1_disagree': n_bad, 'k1_examples': bad,
                      'times': times}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('roots', nargs='*')
    ap.add_argument('--child')
    ap.add_argument('--k1-dump')
    a = ap.parse_args()
    if a.child:
        child(a.child, a.k1_dump)
        return 0
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=30, check=True)
    print(smi.stdout.strip(), flush=True)
    rc = 0
    for root in a.roots:
        cmd = [sys.executable, os.path.abspath(__file__), '--child', root]
        if a.k1_dump:
            cmd += ['--k1-dump', os.path.join(
                a.k1_dump, os.path.basename(os.path.abspath(root)))]
        r = subprocess.run(cmd, timeout=600)
        rc = rc or r.returncode
    return rc


if __name__ == '__main__':
    sys.exit(main())
