"""Build and load the port's CUDA kernels.

The kernel sources in ``csrc/`` (``window.cu``, ``scatter.cu``,
``gather.cu``, ``knn_field.cu``) have plain ``extern "C"`` launch
functions and include no PyTorch header, so ``nvcc`` compiles each in
seconds.  On first use :func:`lib` compiles the sources in parallel (one
``nvcc`` process per source), links them into one ``libcsw_kernels.so``
for ``sm_90a`` and loads it with ``ctypes``.

The library lives in ``ch_shrinkwrap_torch/_build/<sha256>/``, keyed by
the sources and the flags.  A build works in a private temporary
directory and ``os.replace``s the finished library into place, so there
is no lock file to go stale and a killed build leaves no half-written
library behind.  No ``ninja``, no pybind, no
``torch.utils.cpp_extension``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
SOURCES = ('window.cu', 'scatter.cu', 'gather.cu', 'knn_field.cu')
BUILD_ROOT = os.path.join(_PKG, '_build')
LIB_NAME = 'libcsw_kernels.so'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                '-Xptxas=-v']
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on the PATH."""
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root:
            p = os.path.join(root, 'bin', 'nvcc')
            if os.path.exists(p):
                return p
    p = shutil.which('nvcc')
    if p is None:
        raise RuntimeError('nvcc not found: the CUDA kernels build only '
                           'on a machine with the CUDA toolkit')
    return p


def source_hash():
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        with open(os.path.join(CSRC, name), 'rb') as fh:
            h.update(fh.read())
    h.update(' '.join(FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path():
    return os.path.join(BUILD_ROOT, source_hash(), LIB_NAME)


def build():
    """Compile and link ``libcsw_kernels.so`` unless the current
    sources' library already exists.  Returns (path, log): the
    compiler's output, with ptxas' register and shared-memory report,
    or '' when the library was already built."""
    path = lib_path()
    if os.path.exists(path):
        return path, ''
    nvcc = nvcc_path()
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix='tmp-', dir=out_dir)
    try:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + '.o')
            cmd = [nvcc, *FLAGS, '-c', os.path.join(CSRC, name),
                   '-o', obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, objs, failed = [], [], []
        for name, obj, p in procs:
            try:
                out, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            logs.append(f'--- {name}\n' + out.decode(errors='replace'))
            objs.append(obj)
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError('nvcc failed on %s:\n%s'
                               % (', '.join(failed), '\n'.join(logs)))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *ARCH, '-shared', '-o', tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=BUILD_TIMEOUT_S)
        logs.append('--- link\n' + link.stdout.decode(errors='replace'))
        if link.returncode != 0:
            raise RuntimeError('nvcc link failed:\n' + '\n'.join(logs))
        os.replace(tmp_lib, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return path, '\n'.join(logs)


def _declare(L):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    L.csw_window_min.argtypes = [
        vp, vp, vp, vp, vp,                 # pts, starts, cand4, sub4, sub_ids
        i32, i32, i32, i32, i32,            # nb, B, A, W, nsub
        vp, vp, vp,                         # d2, fid, js
        vp]                                 # stream
    L.csw_window_min.restype = i32
    L.csw_window_schedule.argtypes = [vp, vp, vp]  # tile, group_span, chunk
    L.csw_window_schedule.restype = None
    plan = ctypes.POINTER(ctypes.c_int)
    i64 = ctypes.c_longlong
    L.csw_windowed_scatter.argtypes = [
        vp, vp, vp, vp,                     # fid, js, starts, sub_ids
        i32, i32, i32, i32, i32, i32,       # N, B, A, W, smax, nsub
        i32, i32,                           # num_segments, discard_sub
        vp, vp, vp,                         # w, res, vals
        i32, i32, i32,                      # mode, C, Cp
        plan, i32,                          # digit plan, passes
        vp, i64,                            # workspace, its ints
        vp,                                 # out
        vp]                                 # stream
    L.csw_windowed_scatter.restype = i32
    L.csw_segment_sum.argtypes = [
        vp, vp, i32,                        # rows, target, target int64
        i32, i32, i32,                      # N, num_segments, C
        vp,                                 # init
        plan, i32,                          # digit plan, passes
        vp, i64,                            # workspace, its ints
        vp,                                 # out
        vp]                                 # stream
    L.csw_segment_sum.restype = i32
    L.csw_segment_order.argtypes = [
        vp, i32,                            # target, target int64
        i32, i32,                           # N, num_segments
        plan, i32,                          # digit plan, passes
        vp, i64,                            # workspace, its ints
        vp]                                 # stream
    L.csw_segment_order.restype = i32
    L.csw_row_gather.argtypes = [
        vp, i32, i32, vp, i32, vp,          # src, V, C, idx, R, out
        vp]                                 # stream
    L.csw_row_gather.restype = i32
    L.csw_row_group_sum.argtypes = [
        vp, i32, i32, vp, vp, i32, i32, vp,  # src, V, C, idx, care, K, R, out
        vp]                                  # stream
    L.csw_row_group_sum.restype = i32
    f32 = ctypes.c_float
    L.csw_knn_bin.argtypes = [
        vp, i32,                            # pts, N
        f32, f32, f32, f32, i32, i32, i32,  # lo, cell edge, dims
        vp,                                 # cell
        vp]                                 # stream
    L.csw_knn_bin.restype = i32
    L.csw_knn_gather.argtypes = [
        vp, vp, i32,                        # pts, perm, N
        vp,                                 # sorted points
        vp]                                 # stream
    L.csw_knn_gather.restype = i32
    L.csw_knn_field.argtypes = [
        vp, vp,                             # sorted points, offsets
        f32, f32, f32, f32, i32, i32, i32,  # lo, cell edge, dims
        i32, f32,                           # nblock, margin
        vp, i32, i32, f32,                  # queries, Q, k, bound
        vp, vp,                             # out, live
        vp]                                 # stream
    L.csw_knn_field.restype = i32
    L.csw_error_string.argtypes = [i32]
    L.csw_error_string.restype = ctypes.c_char_p


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build()[0])
            _declare(L)
            _lib = L
    return _lib


def check(err, what):
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = lib().csw_error_string(err).decode(errors='replace')
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')


def stream_ptr(t):
    """PyTorch's current CUDA stream on ``t``'s device, as an int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*tensors):
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != 'cuda' or t.device != dev:
            raise ValueError(f'kernel inputs must share one CUDA device, '
                             f'got {t.device} and {dev}')
        if not t.is_contiguous():
            raise ValueError('kernel inputs must be contiguous')
