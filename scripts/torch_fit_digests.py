"""sha256 digests of the card's 20-iteration fit and north-star fit, for
one or more checkouts of this repository, each in a process of its own,
in the order given.

    python3 scripts/torch_fit_digests.py ROOT [ROOT ...]

ROOT is the root of a checkout: its ``ch_shrinkwrap_torch`` is imported
and its kernels are built.  The fits are this checkout's
``chip_smoke.phase_fit`` and ``chip_smoke.phase_fit99`` (the 1e6-point
R = 500 nm sphere cloud from its marching seed), so two versions of the
port run the same fits: equal digests mean the same final mesh bit for
bit.  Prints one JSON line per ROOT (fit seconds, vertex count, mean
radius, the digests of the vertices and the faces).  Needs one CUDA
device.
"""

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        '_chip_smoke_digests', os.path.join(HERE, 'chip_smoke.py'))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import ch_shrinkwrap_torch
    out = {'root': root,
           'package': os.path.dirname(ch_shrinkwrap_torch.__file__)}
    for name, fn in (('fit20', cs.phase_fit), ('fit99', cs.phase_fit99)):
        r = fn()
        out[name] = {k: r[k] for k in ('fit_s', 'V', 'R_mean',
                                       'sha_vertices', 'sha_faces')}
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == '--child':
        child(sys.argv[2])
        return 0
    rc = 0
    for root in sys.argv[1:]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--child', root], timeout=900)
        rc = rc or r.returncode
    return rc


if __name__ == '__main__':
    sys.exit(main())
