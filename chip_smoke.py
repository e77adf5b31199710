"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 window search, K2 windowed scatter,
K3 row gather and K3f, the fold's fused gather + masked group sum) with
nvcc, holds each against its plain PyTorch version at the shapes of the
fit's path, and reads each kernel's device time (torch.profiler kernel
events) beside its bound, its plain version's and a library call's, on
the path's own inputs.  It then times the bench configuration's CG
block, and drives the 20-iteration no-surgery MembraneMesh.shrink_wrap
fit of a 1e6-localization sphere cloud (R = 500 nm, sigma = 5 nm) from
its marching-cubes seed, counting the kernels' launches during the fit.
The fit is then repeated with every kernel replaced by its plain
version (the two surfaces must agree), and run for 39 iterations (the
reference recipe's default), which must land within 1.5 nm of R.

Phases run in order (env, build, kernels, cg_block, fit), each under a
watchdog deadline: a phase that overruns prints its name and elapsed
time and the process exits non-zero.  Any failed check exits non-zero.
The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device; exits non-zero
without printing a result when there is none.  The cg_block phase also
prints torch.profiler's table of one CG block (time by kernel).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

# per-phase deadlines in seconds (the whole run must end well inside
# 1200 s; the expected total on an H100 is a few minutes)
DEADLINES = {'env': 60, 'build': 240, 'kernels': 200, 'cg_block': 180,
             'fit': 480}

# H100 SXM peaks (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_POINTS = 1_000_000
RADIUS = 500.0
SIGMA = 5.0


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


class Watchdog:
    """Exit the process (os._exit) when a phase overruns its deadline."""

    def __init__(self, phase, seconds):
        self.phase = phase
        self.seconds = seconds
        self.t0 = time.time()
        self.timer = threading.Timer(seconds, self._fire)
        self.timer.daemon = True

    def _fire(self):
        msg = (f'WATCHDOG: phase {self.phase} overran its {self.seconds} s '
               f'deadline ({time.time() - self.t0:.1f} s elapsed)')
        print(msg, flush=True)
        print(msg, file=sys.stderr, flush=True)
        os._exit(3)

    def __enter__(self):
        self.timer.start()
        return self

    def __exit__(self, *exc):
        self.timer.cancel()
        return False


def phase_line(phase, seconds, /, **checks):
    parts = ' '.join(f'{k}={v}' for k, v in checks.items())
    print(f"[phase {phase}] {seconds:.2f}s {parts}", flush=True)


def sphere_cloud(n=N_POINTS, radius=RADIUS, sigma=SIGMA, seed=0):
    """The benchmark cloud: n points on a sphere plus isotropic
    Gaussian localization error (numpy seed)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * radius + rng.normal(scale=sigma, size=(n, 3))
           ).astype(np.float32)
    return pts, np.full((n, 3), sigma, np.float32)


def time_ms(fn, reps=10, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current CUDA stream,
    from CUDA events around ``reps`` back-to-back calls (host work of
    the call included)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, match=None, reps=20, warmup=3):
    """Device time of ``fn`` from the device events torch.profiler
    records over ``reps`` calls.  With ``match``, the mean duration of
    a launch of the kernels whose name contains it (a kernel's own
    time; the profiler now and then drops an event, so this averages
    over the launches it saw); without, the summed duration of every
    kernel, copy and fill the calls made, per call (a library call's
    or a plain version's time).  Returns dict(ms, call_ms = CUDA-event
    wall per call, launches = matched device events per call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call_ms = time_ms(fn, reps=reps, warmup=warmup)
    # the profiler now and then records no device event at all for a
    # window; such a window is read again, up to three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and (match is None or match in e.name)]
        if evs:
            break
    check(len(evs) > 0, f'profiler saw no device event'
          f'{" named " + match if match else ""}')
    us = sum(e.time_range.end - e.time_range.start for e in evs)
    return dict(ms=us / 1e3 / (len(evs) if match else reps),
                call_ms=call_ms, launches=len(evs) / reps)


def bound_ms(n_bytes, n_flops):
    """Least time the card could take: max of bytes over the HBM rate
    and fp32 operations over the fp32 peak.  Returns (ms, bound_by)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / FP32_FLOPS_PER_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def nbytes(*tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def phase_env():
    import torch
    out = {'torch': torch.__version__, 'cuda': torch.version.cuda,
           'device': torch.cuda.get_device_name(0),
           'count': torch.cuda.device_count()}
    from ch_shrinkwrap_torch.ops import _build
    r = subprocess.run([_build.nvcc_path(), '--version'],
                       capture_output=True, text=True, timeout=30,
                       check=True)
    out['nvcc'] = r.stdout.strip().splitlines()[-1]
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30, check=True)
    out['nvidia_smi'] = smi.stdout.strip().splitlines()[0]
    return out


def phase_build():
    """Compile (when not yet built) and load the kernel library;
    returns (library path, compiler log)."""
    from ch_shrinkwrap_torch.ops import _build
    path, log = _build.build()
    _build.lib()
    return path, log


def _kernel_mesh(device):
    """A remeshed ~2.4e5-vertex R = 500 sphere, spatially sorted and
    padded as the fit pads its meshes."""
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.mesh.remesh import remesh
    from ch_shrinkwrap_torch.ops import meshdata
    v, f = icosphere(7, radius=RADIUS)
    mesh = TriangleMesh(v, f)
    remesh(mesh, n=5, target_edge_length=3.8, n_relax=0)
    mesh.spatial_sort()
    return mesh, meshdata.from_mesh(mesh, quantum=1024,
                                    hilbert_faces=False, device=device)


def path_inputs(device='cuda', n_points=N_POINTS, mesh_fn=_kernel_mesh):
    """Every kernel's inputs at the fit path's shapes, made only with
    calls that each version of the port has: K1's window search of the
    sorted 1e6-point cloud over a remeshed R = 500 sphere, K2's 'ah'
    rows on K1's own face ids and subsample slots (no polish, as
    ``cg_block`` runs), the three gathers' tables and index streams,
    and the fold's (3 Fp, 7) corner rows."""
    import torch
    from types import SimpleNamespace
    from ch_shrinkwrap_torch.ops import correspondence as corr
    from ch_shrinkwrap_torch.ops import cuda_window, meshdata
    from ch_shrinkwrap_torch.ops.ordering import fit_point_order
    dev = torch.device(device)
    pts_np, _ = sphere_cloud(n_points)
    pts_np = np.ascontiguousarray(pts_np[fit_point_order(pts_np)])
    mesh, ma = mesh_fn(dev)
    pts = torch.from_numpy(pts_np).to(dev)
    centers = ma.positions[ma.faces.long()].mean(1)
    Fp = ma.faces.shape[0]
    Vp = ma.positions.shape[0]
    Fp_al = -(-Fp // 128) * 128
    W = min(corr.CORR_W, Fp_al)
    starts = corr.windowed_anchor_starts(pts, centers, ma.f_mask)
    prep = corr.windowed_points_prep(pts)
    sub_ids = torch.from_numpy(corr._subsample_ids(Fp, 1024)).to(
        dev).int()
    c2 = corr._masked_c2(centers, ma.f_mask)
    k1_args = (prep.blocks_t, starts, centers.T.contiguous(), c2, sub_ids,
               W, 3)
    d2k, fidk, jsk = cuda_window.window_min(*k1_args)
    N = n_points
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.rand((N, 3), generator=g, device=dev) * 0.9 + 0.1
    w = w / w.sum(1, keepdim=True)
    res = torch.randn((N, 3), generator=g, device=dev)
    tables = meshdata.gather_tables(ma)
    f = ma.positions
    vn = torch.nn.functional.normalize(f, dim=1)
    # corner rows of pad faces are zero on the path (their normals and
    # accumulators are masked)
    fused = torch.randn((3 * Fp, 7), generator=g, device=dev) \
        * ma.f_mask.repeat_interleave(3)[:, None]
    gathers = {'tri': (f, tables.tri_idx),
               'ncc': (torch.cat([f, vn], 1), tables.ncc_idx),
               'S': (torch.randn((Vp, 9), generator=g, device=dev),
                     tables.tri_idx)}
    return SimpleNamespace(
        dev=dev, mesh=mesh, ma=ma, pts=pts, centers=centers, Fp=Fp,
        Vp=Vp, Fp_al=Fp_al, W=W, N=N, starts=starts, prep=prep,
        sub_ids=sub_ids, k1_args=k1_args, k1_out=(d2k, fidk, jsk),
        meta_starts=torch.clamp((starts // 128) * 128, 0,
                                max(Fp_al - W, 0)).int(),
        fid=fidk.reshape(-1)[:N], js=jsk.reshape(-1)[:N], w=w, res=res,
        g=g, tables=tables, fused=fused, gathers=gathers)


def k1_tie_cases(device, W=256, nsub=64):
    """K1 inputs whose minima are exact ties, each with the face id and
    subsample slot of the first minimum in concatenation order (windows
    in anchor order, then the subsample).  The points sit at the
    origin, where the distance is c2 exactly, and the tied faces share
    c2 = 1 while every other face has a larger, distinct c2.  Yields
    (name, window_min args, expected fid, expected js)."""
    import torch
    from ch_shrinkwrap_torch.ops import correspondence as corr
    dev = torch.device(device)
    Fp = 4 * W
    sub = corr.subsample_ids(Fp, nsub, dev)
    sub_l = sub.tolist()
    hi = next(k for k, f in enumerate(sub_l) if f >= W)
    lo = next(k for k, f in enumerate(sub_l) if f < 2 * W)
    cases = [
        # the first window starts at the higher face id
        ('two_windows', [2 * W, W, 0], [2 * W + 5, 5], 2 * W + 5, 0),
        ('one_window', [0, W, 2 * W], [W + 40, W + 9], W + 9, 0),
        # window face (lower id) against a subsample face
        ('window_then_sub', [0, 0, 0], [sub_l[hi], 10], 10, 0),
        # window face (higher id) against a subsample face
        ('window_then_lower_sub', [2 * W] * 3, [sub_l[lo], 2 * W + 3],
         2 * W + 3, 0),
        ('two_subs', [0, 0, 0], [sub_l[hi + 2], sub_l[hi + 1]],
         sub_l[hi + 1], hi + 1),
    ]
    g = torch.Generator().manual_seed(0)
    centers_t = torch.randn((3, Fp), generator=g).to(dev)
    blocks_t = torch.zeros((1, 3, 256), device=dev)
    for name, starts, tied, fid, js in cases:
        c2 = torch.linspace(10.0, 20.0, Fp, device=dev)
        c2[torch.tensor(tied, device=dev)] = 1.0
        args = (blocks_t, torch.tensor([starts], dtype=torch.int32,
                                       device=dev), centers_t, c2, sub, W, 3)
        yield name, args, fid, js


def k1_boundary_cases(device, seams):
    """K1 tie cases placed on a schedule's seams, ``seams = (tile,
    group_span, chunk)`` as ``cuda_window.schedule()`` reports the
    built kernel's: two tied faces at concatenation positions on either
    side of a chunk boundary, of two thread groups' spans, of a staging
    tile, and an earlier group of a later tile against a later group of
    an earlier tile; with W = 1024 or 1000 and nsub = 64 or 60, which
    are no multiples of the tile (or of the chunk).  The points sit at
    the origin and only the tied faces have c2 = 1, as in
    :func:`k1_tie_cases`.  Yields (name, window_min args, expected fid,
    expected js), the expectation being the first position in
    concatenation order that holds a tied face."""
    import torch
    from ch_shrinkwrap_torch.ops import correspondence as corr
    TILE, GROUP_SPAN, CHUNK = seams
    dev = torch.device(device)
    Fp = 4096
    starts = [0, 1024, 2048]
    g = torch.Generator().manual_seed(1)
    centers_t = torch.randn((3, Fp), generator=g).to(dev)
    blocks_t = torch.zeros((1, 3, 256), device=dev)
    for W, nsub in ((1024, 64), (1000, 60)):
        sub = corr.subsample_ids(Fp, nsub, dev)
        faces = [s0 + i for s0 in starts for i in range(W)] + sub.tolist()
        n = len(faces)
        pairs = {'chunk': (CHUNK - 1, CHUNK),
                 'chunk_pair': (2 * CHUNK - 1, 2 * CHUNK),
                 'groups': (GROUP_SPAN - 1, GROUP_SPAN),
                 'tiles': (TILE - 1, TILE),
                 'later_tile_first_group': (TILE - 3, TILE + 5),
                 'earlier_tile_later_group': (2 * GROUP_SPAN + 1,
                                              TILE + 1),
                 'last_tile': ((n - 1) // TILE * TILE - 1, n - 1),
                 'window_vs_sub': (W + 3, 3 * W + 2)}
        for name, pos in pairs.items():
            tied = {faces[q] for q in pos}
            first = min(q for q in range(n) if faces[q] in tied)
            c2 = torch.linspace(10.0, 20.0, Fp, device=dev)
            c2[torch.tensor(sorted(tied), device=dev)] = 1.0
            args = (blocks_t, torch.tensor([starts], dtype=torch.int32,
                                           device=dev), centers_t, c2, sub,
                    W, 3)
            yield (f'{name}_W{W}_nsub{nsub}', args, faces[first],
                   max(first - 3 * W, 0))


def k1_lattice_case(device, nb=64, Fp=4096, W=1024, nsub=256, seed=0):
    """K1 inputs on an integer lattice: points and centres with small
    integer coordinates, so every distance is an exact integer and
    many minima are exact ties."""
    import torch
    from ch_shrinkwrap_torch.ops import correspondence as corr
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    pts = rng.integers(-4, 5, (nb, 3, 256)).astype(np.float32)
    cen = rng.integers(-4, 5, (3, Fp)).astype(np.float32)
    starts = (rng.integers(0, (Fp - W) // 128 + 1, (nb, 3)) * 128)
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(pts), t(starts.astype(np.int32)), t(cen),
            t((cen * cen).sum(0)), corr.subsample_ids(Fp, nsub, dev), W, 3)


def adversarial_rows(inp):
    """K2 rows that leave the fit path: a two-step adjacency polish
    moves some faces, and 0.1% of the rows get a random face, so rows
    lie outside every window of their block and pile onto subsample
    faces."""
    import torch
    from ch_shrinkwrap_torch.ops import correspondence as corr
    _, fid = corr.refine_correspondence(inp.pts, inp.centers,
                                        inp.ma.face_nbrs, inp.fid, n_iter=2)
    pick = torch.rand(inp.N, generator=inp.g, device=inp.dev) < 1e-3
    rand_f = torch.randint(0, inp.mesh.faces.shape[0], (inp.N,),
                           generator=inp.g, device=inp.dev,
                           dtype=torch.int32)
    return torch.where(pick, rand_f, fid).int()


def phase_kernels(device='cuda', n_points=N_POINTS, mesh_fn=_kernel_mesh,
                  timer=device_ms):
    """Each kernel against its plain version on the same inputs, at the
    fit path's shapes, and its device time beside its bound, its plain
    version's and a library call's.  Returns the per-kernel records."""
    import torch
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_gather
    from ch_shrinkwrap_torch.solver.shrinkwrap import _fold
    inp = path_inputs(device, n_points, mesh_fn)
    dev, N, Fp, Vp, W = inp.dev, inp.N, inp.Fp, inp.Vp, inp.W
    recs = {}

    # ---- K1 --------------------------------------------------------
    d2k, fidk, jsk = inp.k1_out
    d2p, fidp, jsp = cuda_window.window_min_plain(*inp.k1_args)
    # the kernel and its plain version form the same FMA chain: equal
    # ids and slots, and d2 equal bit for bit
    n_fid = int((fidk != fidp).sum())
    n_js = int((jsk != jsp).sum())
    n_d2 = int((d2k.view(torch.int32) != d2p.view(torch.int32)).sum())
    k1_err = float((d2k - d2p).abs().max())
    check(n_fid == 0, f'K1: {n_fid} face ids differ')
    check(n_js == 0, f'K1: {n_js} subsample slots differ')
    check(n_d2 == 0, f'K1: {n_d2} d2 differ in bits (max {k1_err})')
    for name, args, fid, js in (
            *k1_tie_cases(dev),
            *k1_boundary_cases(dev, cuda_window.schedule())):
        for fn in (cuda_window.window_min, cuda_window.window_min_plain):
            _, f_, j_ = fn(*args)
            check(bool((f_ == fid).all()) and bool((j_ == js).all()),
                  f'K1 tie {name} ({fn.__name__}): fid {f_[0, 0]} js '
                  f'{j_[0, 0]}, want the first minimum {fid} / {js}')
    lat = k1_lattice_case(dev)
    lat_k = cuda_window.window_min(*lat)
    lat_p = cuda_window.window_min_plain(*lat)
    lat_c = cuda_window.window_min_plain(*(
        a.cpu() if torch.is_tensor(a) else a for a in lat))
    for a_, b_, c_ in zip(lat_k, lat_p, lat_c):
        check(torch.equal(a_, b_) and torch.equal(a_.cpu(), c_),
              'K1 lattice ties: kernel, plain and CPU plain differ')
    nb, _, B = inp.prep.blocks_t.shape
    n_cand = 3 * W + inp.sub_ids.numel()
    k1_bytes = (nbytes(inp.prep.blocks_t, inp.starts, inp.sub_ids, d2k,
                       fidk, jsk) + 16 * (inp.Fp_al + inp.sub_ids.numel()))
    # 3 mul, 3 add and 1 min a candidate at the fp32 peak (FMA counted
    # as two); the kernel issues about 5 instructions a candidate (FMUL,
    # 2 FFMA, FADD, FMNMX) at one warp instruction a clock per SM
    # sub-partition, half the flop rate
    k1_flops = 7.0 * nb * B * n_cand
    bms, bby = bound_ms(k1_bytes, k1_flops)
    issue_ms = 5.0 * nb * B * n_cand / (FP32_FLOPS_PER_S / 2) * 1e3
    t1 = timer(lambda: cuda_window.window_min(*inp.k1_args),
               match='window_min', reps=10)
    recs['K1'] = dict(
        name='window_min', route='cuda',
        source='ch_shrinkwrap_torch/csrc/window.cu',
        replaces='JAX package ops/pallas_kernels.py:26 _window_kernel',
        max_abs_err=k1_err, ms=t1['ms'], call_ms=t1['call_ms'],
        plain_ms=timer(lambda: cuda_window.window_min_plain(*inp.k1_args),
                       reps=3, warmup=1)['ms'],
        bound_ms=bms, bound_by=bby, library_ms=None,
        checks=dict(fid_differ=n_fid, js_differ=n_js, d2_differ=n_d2,
                    issue_bound_ms=issue_ms,
                    tie_cases='first minimum', lattice='equal',
                    V=int(inp.mesh.vertices.shape[0]), Vp=Vp, Fp=Fp,
                    n_cand=n_cand))

    # ---- K2: the path's rows, and rows outside every window ----------
    vals = torch.randn((N, 12), generator=inp.g, device=dev)
    fid_adv = adversarial_rows(inp)
    k2_err, k2 = {}, {}
    for rows_name, fid in (('path', inp.fid), ('adversarial', fid_adv)):
        tgt = cuda_scatter.route(fid, inp.js, inp.meta_starts, inp.sub_ids,
                                 W, 256, False)
        n_out = int((tgt != fid.long()).sum())
        if rows_name == 'path':
            check(n_out == 0, f'K2: {n_out} path rows leave their face')
        else:
            check(n_out > 0, 'K2: no adversarial row outside every window')
        for mode in ('ah', 'ahw2', 'w2', 'given'):
            args = (mode, inp.w, inp.res if mode in ('ah', 'ahw2') else None,
                    vals if mode == 'given' else None, fid, inp.js,
                    inp.meta_starts, inp.sub_ids, Fp)
            out = cuda_scatter.windowed_scatter(*args)
            ref = cuda_scatter.windowed_scatter_plain(*args)
            err = float((out - ref).abs().max())
            tol = 1e-4 * float(ref.abs().max())
            check(err <= tol, f'K2 {mode} on {rows_name} rows: max err '
                  f'{err} > {tol}')
            k2_err[f'{rows_name}_{mode}'] = err
        ah = ('ah', inp.w, inp.res, None, fid, inp.js, inp.meta_starts,
              inp.sub_ids, Fp)
        rows = cuda_scatter._columns('ah', inp.w, inp.res, None)
        keep = tgt >= 0
        rows_k, tgt_k = rows[keep].contiguous(), tgt[keep].contiguous()
        lib_out = torch.zeros((Fp, 12), device=dev)
        t2 = timer(lambda: cuda_scatter.windowed_scatter(*ah),
                   match='windowed_scatter')
        k2[rows_name] = dict(
            ms=t2['ms'], call_ms=t2['call_ms'], rows_outside=n_out,
            plain_ms=timer(lambda: cuda_scatter.windowed_scatter_plain(
                *ah), reps=5)['ms'],
            library_ms=timer(lambda: lib_out.index_add_(0, tgt_k,
                                                        rows_k))['ms'])
    k2_bytes = (nbytes(inp.w, inp.res, inp.fid, inp.js, inp.meta_starts,
                       inp.sub_ids) + Fp * 12 * 4)
    bms, bby = bound_ms(k2_bytes, 24.0 * N)
    recs['K2'] = dict(
        name='windowed_scatter', route='cuda',
        source='ch_shrinkwrap_torch/csrc/scatter.cu',
        replaces='JAX package ops/pallas_scatter.py:44 _scatter_kernel',
        max_abs_err=k2_err['path_ah'], ms=k2['path']['ms'],
        call_ms=k2['path']['call_ms'], plain_ms=k2['path']['plain_ms'],
        bound_ms=bms, bound_by=bby, library_ms=k2['path']['library_ms'],
        checks=dict(adversarial=k2['adversarial'],
                    **{f'err_{k}': v for k, v in k2_err.items()}))

    # ---- K3: the tri, ncc and S gathers of one iteration --------------
    k3 = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0)
    per_call = {}
    for key, (src, idx) in inp.gathers.items():
        out = cuda_gather.row_gather(src, idx)
        check(torch.equal(out, cuda_gather.row_gather_plain(src, idx)),
              f'K3 {key}: not exact')
        idx64 = idx.long()
        t3 = timer(lambda: cuda_gather.row_gather(src, idx),
                   match='row_gather')
        r = dict(ms=t3['ms'], call_ms=t3['call_ms'],
                 plain_ms=timer(lambda: cuda_gather.row_gather_plain(
                     src, idx))['ms'],
                 library_ms=timer(lambda: torch.index_select(
                     src, 0, idx64))['ms'])
        per_call[key] = {k: round(v, 5) for k, v in r.items()}
        for k, v in r.items():
            k3[k] += v
        k3['bytes'] += nbytes(src, idx, out)
    bms, bby = bound_ms(k3['bytes'], 0.0)
    recs['K3'] = dict(
        name='row_gather', route='cuda',
        source='ch_shrinkwrap_torch/csrc/gather.cu',
        replaces='JAX package ops/pallas_gather.py:111 _gather_kernel',
        max_abs_err=0.0, ms=k3['ms'], call_ms=k3['call_ms'],
        plain_ms=k3['plain_ms'], bound_ms=bms, bound_by=bby,
        library_ms=k3['library_ms'],
        checks=dict(per='one iteration: tri + ncc + S gathers',
                    **per_call))

    # ---- K3f: the fold's fused gather + masked group sum --------------
    t = inp.tables
    fused, faces_l = inp.fused, inp.ma.faces.reshape(-1).long()
    out = cuda_gather.row_group_sum(fused, t.fold_idx, t.fold_care)
    ref = cuda_gather.row_group_sum_plain(fused, t.fold_idx, t.fold_care)
    err = float((out - ref).abs().max())
    check(err <= 1e-4 * float(ref.abs().max()),
          f'K3f vs its plain version: {err}')
    fold = _fold(fused, inp.ma.faces, Vp, t)
    fold_ref = _fold(fused, inp.ma.faces, Vp, None)
    fold_err = float((fold - fold_ref).abs().max())
    check(fold_err <= 1e-4 * float(fold_ref.abs().max()),
          f'K3f fold vs index_add_: {fold_err}')
    lib_out = torch.zeros((Vp, 7), device=dev)
    KI = t.fold_care.shape[1]
    care_f = t.fold_care[..., None].float()

    def gather_mask_sum():
        g_ = cuda_gather.row_gather(fused, t.fold_idx).reshape(Vp, KI, 7)
        return (g_ * care_f).sum(1)

    tf = timer(lambda: cuda_gather.row_group_sum(fused, t.fold_idx,
                                                 t.fold_care),
               match='row_group_sum')
    bms, bby = bound_ms(nbytes(fused, t.fold_idx, t.fold_care, out), 0.0)
    recs['K3f'] = dict(
        name='row_group_sum', route='cuda',
        source='ch_shrinkwrap_torch/csrc/gather.cu',
        replaces='JAX package ops/pallas_gather.py:111 _gather_kernel '
                 '+ masked sum solver/shrinkwrap.py:500',
        max_abs_err=err, ms=tf['ms'], call_ms=tf['call_ms'],
        plain_ms=timer(lambda: cuda_gather.row_group_sum_plain(
            fused, t.fold_idx, t.fold_care))['ms'],
        bound_ms=bms, bound_by=bby,
        library_ms=timer(lambda: lib_out.index_add_(0, faces_l,
                                                    fused))['ms'],
        checks=dict(fold_err=fold_err,
                    gather_mask_sum_ms=timer(gather_mask_sum)['ms'],
                    fold_ms=timer(lambda: _fold(fused, inp.ma.faces, Vp,
                                                t))['ms']))
    return recs


def phase_cg_block(device='cuda', n_points=N_POINTS, ico_sub=7, rf=5,
                   n_blocks=3):
    """The bench configuration: 1e6 points, icosphere(7) at r = 550,
    rf = 5, n_blocks timed blocks after one warm-up block, then one
    block under torch.profiler.  Returns (readings, profiler table)."""
    import torch
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.ops import meshdata
    from ch_shrinkwrap_torch.ops.ordering import fit_point_order
    from ch_shrinkwrap_torch.solver.shrinkwrap import cg_block
    from ch_shrinkwrap_torch.utils.tracing import device_profile
    dev = torch.device(device)
    pts, sig = sphere_cloud(n_points)
    pts = np.ascontiguousarray(pts[fit_point_order(pts)])
    sigma_inv = (1.0 / sig).astype(np.float32)
    weights = sigma_inv / sigma_inv.mean()
    v, f = icosphere(ico_sub, radius=550.0)
    mesh = TriangleMesh(v, f)
    mesh.spatial_sort()
    ma = meshdata.from_mesh(mesh, quantum=1024, hilbert_faces=False,
                            device=dev)
    tables = meshdata.gather_tables(ma) \
        if ma.positions.shape[0] > 32768 else None
    pts_t = torch.from_numpy(pts).to(dev)
    sig_t = torch.from_numpy(sigma_inv).to(dev)
    w_t = torch.from_numpy(weights).to(dev)
    pm = torch.ones(n_points, dtype=torch.bool, device=dev)

    def block(pos):
        return cg_block(pos, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
                        pts_t, sig_t, w_t, pm, 2.0, num_iters=rf,
                        corr_method='windowed', face_nbrs=ma.face_nbrs,
                        tables=tables,
                        face_hcgc=ma.positions.shape[0]
                        > meshdata.HCGC_MIN_VP)

    f1, _ = block(ma.positions)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n_blocks):
        f1, diag = block(f1)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    dt = time.time() - t0
    checksum = float(f1.sum())
    check(np.isfinite(checksum), 'cg_block checksum not finite')
    check(bool(torch.isfinite(f1).all()), 'cg_block positions not finite')
    with device_profile() as prof:
        block(f1)
        if dev.type == 'cuda':
            torch.cuda.synchronize()
    sort = 'cuda_time_total' if dev.type == 'cuda' else 'cpu_time_total'
    prof_table = prof.key_averages().table(sort_by=sort, row_limit=20)
    return dict(iters_per_s=n_blocks * rf / dt, seconds=dt,
                checksum=checksum, Vp=int(ma.positions.shape[0]),
                n_done=int(diag.n_done)), prof_table


def kernel_wrappers():
    """The four kernel wrappers, whose ``launches`` count kernel
    launches."""
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_gather
    return {'K1': cuda_window.window_min,
            'K2': cuda_scatter.windowed_scatter,
            'K3': cuda_gather.row_gather,
            'K3f': cuda_gather.row_group_sum}


@contextlib.contextmanager
def plain_versions():
    """Route the fit's path through each kernel's plain PyTorch version
    (the reference run held against the kernels on the same card)."""
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_gather
    from ch_shrinkwrap_torch.solver import shrinkwrap
    saved = (cuda_window.window_min, cuda_scatter.windowed_scatter,
             shrinkwrap.row_gather, shrinkwrap.row_group_sum)
    cuda_window.window_min = cuda_window.window_min_plain
    cuda_scatter.windowed_scatter = cuda_scatter.windowed_scatter_plain
    shrinkwrap.row_gather = cuda_gather.row_gather_plain
    shrinkwrap.row_group_sum = cuda_gather.row_group_sum_plain
    try:
        yield
    finally:
        (cuda_window.window_min, cuda_scatter.windowed_scatter,
         shrinkwrap.row_gather, shrinkwrap.row_group_sum) = saved


def phase_fit(device='cuda', n_points=N_POINTS, grid_n=48, iters=20,
              radius=RADIUS):
    """The no-surgery fit (20 iterations by default) from the marching
    seed, as a user runs it."""
    import torch
    from ch_shrinkwrap_torch.mesh.marching import wrap_start
    from ch_shrinkwrap_torch.models import MembraneMesh
    pts, sig = sphere_cloud(n_points, radius=radius)
    t0 = time.time()
    surf = wrap_start(pts, offset=25.0, grid_n=grid_n)
    t_seed = time.time() - t0
    mesh = MembraneMesh(
        mesh=surf, kc=1.0, step_size=20.0, max_iter=iters,
        remesh_frequency=5, delaunay_remesh_frequency=0,
        neck_first_iter=-1, device=device)
    V0 = int(mesh.vertices.shape[0])
    t1 = time.time()
    mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                     minimum_edge_length=5.0)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    t_fit = time.time() - t1
    r = np.linalg.norm(mesh.vertices, axis=1)
    _, n_comp = mesh.connected_components()
    return dict(seed_s=t_seed, fit_s=t_fit, V0=V0,
                V=int(mesh.vertices.shape[0]),
                R_mean=float(r.mean()), R_std=float(r.std()),
                euler=int(mesh.euler_characteristic),
                manifold=bool(mesh.is_manifold), components=int(n_comp),
                method=mesh._last_corr_method,
                trace=[(rec.kind, rec.iteration, round(rec.wall_time, 3),
                        rec.n_vertices, rec.extra.get('v_cap', ''))
                       for rec in mesh.trace.records])


def check_fit(fit, radius=RADIUS, mean_tol=1.5, tag='fit'):
    check(abs(fit['R_mean'] - radius) < mean_tol,
          f"{tag} |R - {radius}| = {abs(fit['R_mean'] - radius)} "
          f">= {mean_tol}")
    check(fit['R_std'] < 1.5, f"{tag} R std {fit['R_std']}")
    check(fit['euler'] == 2, f"{tag} euler {fit['euler']}")
    check(fit['manifold'], f'{tag} mesh not manifold')
    check(fit['components'] == 1, f"{tag} components {fit['components']}")


def check_same_fit(fit, ref):
    """The kernel path against the plain path on the same card: the
    same surface up to the order of atomic sums (K2's and index_add_'s),
    which remeshing amplifies — on an H100 the two paths differed by
    up to 0.06 nm in R and 0.2% in vertex count over four runs."""
    d_mean = abs(fit['R_mean'] - ref['R_mean'])
    d_std = abs(fit['R_std'] - ref['R_std'])
    d_v = abs(fit['V'] - ref['V']) / ref['V']
    check(d_mean < 0.2, f'fit vs plain: |dR| = {d_mean} nm')
    check(d_std < 0.1, f'fit vs plain: |d std| = {d_std} nm')
    check(d_v < 0.02, f'fit vs plain: vertex counts differ by {d_v:.3%}')
    return dict(dR=d_mean, dstd=d_std, dV=d_v)


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.time()

    with Watchdog('env', DEADLINES['env']):
        t0 = time.time()
        env = phase_env()
        phase_line('env', time.time() - t0, **{k: repr(v) for k, v
                                               in env.items()})
    with Watchdog('build', DEADLINES['build']):
        t0 = time.time()
        path, log = phase_build()
        phase_line('build', time.time() - t0, built=bool(log), lib=path)
        for line in log.splitlines():
            if 'registers' in line or 'Compiling entry' in line \
                    or 'spill' in line:
                print('  ptxas:', line.strip(), flush=True)
    with Watchdog('kernels', DEADLINES['kernels']):
        t0 = time.time()
        recs = phase_kernels()
        for key, rec in recs.items():
            phase_line(f'kernels.{key}', 0.0, **{
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in rec.items() if k not in ('source', 'replaces')})
        phase_line('kernels', time.time() - t0)
    with Watchdog('cg_block', DEADLINES['cg_block']):
        t0 = time.time()
        cgb, prof_table = phase_cg_block()
        phase_line('cg_block', time.time() - t0, **cgb)
        print(prof_table, flush=True)
    with Watchdog('fit', DEADLINES['fit']):
        wrappers = kernel_wrappers()
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        fit = phase_fit()
        launches = {k: w.launches for k, w in wrappers.items()}
        trace = fit.pop('trace')
        phase_line('fit', time.time() - t0, launches=launches, **fit)
        for rec in trace:
            print('  trace:', *rec, flush=True)
        for key, n in launches.items():
            check(n > 0, f'{key} was not launched during the fit')
        # 20 iterations from the offset-25 seed stop short of the cloud
        # (the JAX package too, PERF.md section 6): the radius bound is
        # one localization sigma; the 39-iteration fit below is held to
        # 1.5 nm
        check_fit(fit, mean_tol=SIGMA)
        t0 = time.time()
        with plain_versions():
            ref = phase_fit()
        ref.pop('trace')
        same = check_same_fit(fit, ref)
        phase_line('fit.plain', time.time() - t0, **same, **ref)
        t0 = time.time()
        conv = phase_fit(iters=39)
        conv.pop('trace')
        phase_line('fit.39it', time.time() - t0, **conv)
        check_fit(conv, tag='39-iteration fit')

    print(f'total {time.time() - t_all:.1f}s', flush=True)
    table = []
    for key in ('K1', 'K2', 'K3', 'K3f'):
        rec = dict(recs[key])
        rec.pop('checks')
        rec['launches'] = launches[key]
        table.append({k: rec[k] for k in (
            'name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'call_ms', 'plain_ms', 'bound_ms',
            'bound_by', 'library_ms')})
    print(env['nvidia_smi'], flush=True)
    print(json.dumps({'kernels': table}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f'CHECK FAILED: {e}', flush=True)
        print(f'CHECK FAILED: {e}', file=sys.stderr, flush=True)
        sys.exit(1)
