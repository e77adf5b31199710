"""The port's remesh engine against a reference engine, bit for bit, on a
fit's growth schedule.

Nineteen growth remeshes of a noisy R = 500 nm icosphere (5
subdivisions, 0.3 nm of noise), targets 14.4 -> 5.3 nm, 5 passes,
``n_relax=0``, with the vertices and faces put in Hilbert order
(``spatial_sort``) between them, as the north-star fit's scheduled
remeshes do.  Each step runs both engines on the same input, in turns
(reference, port, port, reference, ... ``--repeats`` pairs), asserts
equal vertices and faces, and prints one JSON line: the mesh sizes,
each engine's median seconds and the port engine's counters.  The last
line sums the steps.

The reference is a ``topology.cpp`` source compiled here with the
port's flags: the JAX package's ``native/topology.cpp`` (on the CPU
sandbox), or another checkout's ``ch_shrinkwrap_torch/native/
topology.cpp`` (the parent commit's, say), called through the port
wrapper's capacity rule.  Nothing of the JAX package is imported.

    python3 scripts/torch_remesh_ab.py --reference SRC [--repeats N]
"""

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ch_shrinkwrap_torch import native  # noqa: E402
from ch_shrinkwrap_torch.mesh.core import TriangleMesh  # noqa: E402
from ch_shrinkwrap_torch.mesh.primitives import icosphere  # noqa: E402


def load_reference(src, out_dir):
    """``src`` compiled into ``out_dir`` and loaded, with the
    ``remesh_native`` signature that has no counters."""
    lib_path = os.path.join(out_dir, 'libreference.so')
    subprocess.run(['g++', '-O3', '-march=native', '-shared', '-fPIC', '-o',
                    lib_path, src], check=True, timeout=300)
    lib = ctypes.CDLL(lib_path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.remesh_native.argtypes = [
        f32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, f32p, i32p, i32p, i32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float]
    lib.remesh_native.restype = None
    return lib


def reference_remesh(lib, v, f, target, n_passes=5, l=0.5, n_relax=0,
                     max_valence=20):
    """The reference engine through the port wrapper's capacity rule."""
    nv, nf = len(v), len(f)
    v_cap, f_cap = native.remesh_capacity(v, f, target)
    v_out = np.empty((v_cap, 3), np.float32)
    f_out = np.empty((f_cap, 3), np.int32)
    nv_out = np.zeros(1, np.int32)
    nf_out = np.zeros(1, np.int32)
    lib.remesh_native(native._f32p(v), nv, native._i32p(f), nf,
                      ctypes.c_float(target), n_passes, ctypes.c_float(l),
                      n_relax, max_valence, native._f32p(v_out),
                      native._i32p(f_out), native._i32p(nv_out),
                      native._i32p(nf_out), v_cap, f_cap,
                      ctypes.c_float(2.0), ctypes.c_float(0.0))
    if nv_out[0] < 0:
        raise RuntimeError('reference engine overflowed its capacity')
    return v_out[:nv_out[0]].copy(), f_out[:nf_out[0]].copy()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--reference', required=True,
                    help='topology.cpp of the reference engine')
    ap.add_argument('--repeats', type=int, default=3,
                    help='pairs of timed calls a step')
    args = ap.parse_args()

    out_dir = tempfile.mkdtemp(prefix='remesh-ab-')
    try:
        ref = load_reference(args.reference, out_dir)
        native.get_lib()
        v, f = icosphere(5, radius=500.0)
        rng = np.random.default_rng(0)
        v = (v + rng.normal(scale=0.3, size=v.shape)).astype(np.float32)
        totals = {'reference_s': 0.0, 'port_s': 0.0}
        for step, target in enumerate(np.linspace(14.4, 5.3, 19)):
            target = float(target)
            t_ref, t_port = [], []
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                rv, rf = reference_remesh(ref, v, f, target)
                t1 = time.perf_counter()
                pv, pf, counts = native.remesh(v, f, target)
                t2 = time.perf_counter()
                pv, pf, counts = native.remesh(v, f, target)
                t3 = time.perf_counter()
                rv, rf = reference_remesh(ref, v, f, target)
                t4 = time.perf_counter()
                t_ref += [t1 - t0, t4 - t3]
                t_port += [t2 - t1, t3 - t2]
            np.testing.assert_array_equal(pv, rv)
            np.testing.assert_array_equal(pf, rf)
            line = {'step': step, 'target': round(target, 4),
                    'V_in': len(v), 'V_out': len(pv), 'F_out': len(pf),
                    'reference_s': statistics.median(t_ref),
                    'port_s': statistics.median(t_port), **counts}
            totals['reference_s'] += line['reference_s']
            totals['port_s'] += line['port_s']
            print(json.dumps(line), flush=True)
            mesh = TriangleMesh(pv, pf)
            mesh.spatial_sort()
            v, f = mesh.vertices, mesh.faces
        totals['speedup'] = totals['reference_s'] / totals['port_s']
        totals['bit_identical'] = True
        print(json.dumps(totals), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
