"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (K1 window search, K2 windowed scatter
and the ordered segment sum every other accumulation of the fit runs
through, K3 row gather and K3f, the fold's fused gather + masked group
sum, the seed's bounded k-th-NN density field and the brute-force
nearest-face search) with nvcc and the
native host engine (native/topology.cpp, the remesh and surgery of every
fit) with g++, failing when either cannot be built or loaded; holds
each kernel against its plain PyTorch version at the shapes of the
fit's path (bit for bit: every kernel sums in its plain
version's order), K2's and K2s's radix ordering against its plain
version (segment_order: perm and offsets equal), and reads each
kernel's device time (torch.profiler kernel events) beside its bound,
its plain version's and a library call's, on the path's own inputs;
for K2 and K2s also the time of each stage (histogram, scan, scatter,
offsets, reduce) with the case's longest segment, the reduce against
the longest segment up to every row on one face, and K2s with every
row on one vertex.  The seed's field is held to the host engine
(native.knn_field) and to its plain version, bit for bit, on the 1e6
cloud at wrap_start(offset=25, grid_n=48)'s 117,649 queries, and timed
beside both.  The brute-force search is held to its plain version, bit
for bit, at the evaluation sweep's shape (19,700 points, 70,656 faces),
on exact ties placed on its schedule's seams and on a lattice, and
timed beside its bound and its plain version.  It then times the bench
configuration's CG block, and drives the 20-iteration no-surgery
MembraneMesh.shrink_wrap fit of a 1e6-localization sphere cloud (R = 500
nm, sigma = 5 nm) from its marching-cubes seed twice, counting the
kernels' launches during the first fit: the two final meshes must be
equal bit for bit (their sha256 digests are printed).  The fit is then
repeated with every kernel replaced by its plain version (the two
surfaces must agree), and run for 39 iterations (the reference recipe's
default), which must land within 1.5 nm of R.

Phase fit99 drives the north-star fit on the same cloud and seed: 99
iterations, remesh every 5, neck removal after iteration 9, hole
punching every 13, minimum edge 5 nm (scripts/torch_e2e_fit.py's
defaults), twice.  It must end within 1.5 nm of R with a radial std
below 1 nm, one closed manifold sphere, K1 launched once an iteration
and K2, K3 and K3f launched, and the two runs' final meshes equal bit
for bit; it prints the trace, the wall by phase and the digests.
Phase fit.punch fits an oblate seed to a torus cloud and punches
inside the loop on the card, and must make the same cuts as the same
fit on the CPU.

Phase image runs the image recipe (ImageShrinkwrapMembrane with its
defaults: 100 iterations, the shrink prior at weight 1, remesh every 5,
neck removal after iteration 9) on a 3-D histogram of the same cloud at
5 nm voxels, from the same seed, with the north-star neck thresholds
and a 5 nm minimum edge.  It must end within half a voxel of R on one
closed manifold sphere, K1 and K2 launched once an iteration and K3
and K3f launched; the same recipe at 10 iterations through the kernels
and through their plain versions must agree within 0.2 nm in R.
Phase sweep runs the evaluation harness on configs/test_ersim.yaml
(the ERSim shape, 39 iterations): the entry must write a metrics row of
the right topology (euler 0, one manifold component), and a second
evaluate in the same directory must skip it; the same sweep with every
kernel replaced by its plain version must write the same surface bit
for bit and the same row but for the fit's duration.  Its brute-force
search kernel and segment_sum_ordered (the A^T scatter) must launch
there; the windowed fits at their capacity give them no work, so the
kernel table's launches of both are the sweep's.

Phase shard runs the bench configuration's CG block through
sharded_cg_block at world size 1 (NCCL) and 2 against the one-process
block (first-iteration face ids equal, first-iteration positions within
5e-3; two one-process blocks equal bit for bit), then the 20-iteration
fit through sharded_fit over two ranks
(two cards over NCCL where there are two, else both on cuda:0 over
gloo): the same gates as the fit, within 0.2 nm of the one-process R,
K1 and K2 launched once an iteration on rank 0, and the ranks found in
step after every block.  Phase corr holds the hash-grid and blocked
searches to the exact one on the JAX suite's fixture (ids agree > 0.98,
distances within a cell), reads their agreement at the fit's scale,
requires the card's ids to equal the CPU's, and runs the 20-iteration
fit with each.  Phase grids runs four entries of the sweep grids
(GRID_ENTRIES: the collapse veto with punching on two tori, a neck cut
on two capsules directly and through the recipe route, the
tetrahedron) at once, one spawned worker each: every entry must write
a metrics row of a manifold surface with the expected topology and an
sdf_rms within its stated bound of the JAX package's.  Beside them two
workers run one more entry (REPEAT_ENTRY, a separator row whose
topology used to change between runs): their rows must be equal in every
field but the fit's duration.

Phases run in order (env, build, kernels, cg_block, fit, shard, corr,
fit99, fit.punch, image, sweep, grids), each under a watchdog deadline:
a phase that overruns
prints its name and elapsed time and the process exits non-zero.  Any
failed check exits non-zero.  The second-to-last line is the kernel
table as JSON; the last line is {"ok": true, "device": {...}}.  Needs
one CUDA device; exits non-zero without printing a result when there
is none.  The cg_block phase also prints torch.profiler's table of one
CG block (time by kernel).
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

# per-phase deadlines in seconds, each about twice the phase's slowest
# run on an H100 or more; they add up to 1150, so the whole run ends
# inside 1200 s (the expected total is about 10 minutes)
DEADLINES = {'env': 15, 'build': 40, 'kernels': 160, 'cg_block': 20,
             'fit': 95, 'shard': 110, 'corr': 200, 'fit99': 50,
             'punch': 40, 'image': 60, 'sweep': 300, 'grids': 60}

# H100 SXM peaks (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_POINTS = 1_000_000
RADIUS = 500.0
SIGMA = 5.0
VOXEL = 5.0
HERE = os.path.dirname(os.path.abspath(__file__))


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


def device_events(fn, reps, match=None):
    """The device events torch.profiler records over ``reps`` calls of
    ``fn`` (with ``match``, those whose name contains it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
            return evs
    check(False, f'profiler saw no device event'
          f'{" named " + match if match else ""}')


def device_ms(fn, match=None, reps=20, warmup=3):
    """Device time of ``fn`` from the device events torch.profiler
    records over ``reps`` calls.  With ``match``, the mean duration of
    a launch of the kernels whose name contains it (a kernel's own
    time; the profiler now and then drops an event, so this averages
    over the launches it saw); without, the summed duration of every
    kernel, copy and fill the calls made, per call (a library call's
    or a plain version's time).  Returns dict(ms, call_ms = CUDA-event
    wall per call, launches = matched device events per call)."""
    call_ms = time_ms(fn, reps=reps, warmup=warmup)
    evs = device_events(fn, reps, match)
    us = sum(e.time_range.end - e.time_range.start for e in evs)
    return dict(ms=us / 1e3 / (len(evs) if match else reps),
                call_ms=call_ms, launches=len(evs) / reps)


# the device stages of K2 and K2s (the kernels of csrc/scatter.cu): the
# first pass's histogram (K2: fused with the route; K2s: of the clamped
# targets), the later passes' histograms, the per-digit scans, the
# stable scatters, the segment starts and the reduce
K2_STAGES = ('route_hist', 'radix_hist', 'radix_scan', 'radix_scatter',
             'segment_offsets', 'windowed_reduce')
K2S_STAGES = ('key_hist', 'radix_hist', 'radix_scan', 'radix_scatter',
              'segment_offsets', 'segment_reduce')


def device_stages(fn, names, reps=20, warmup=3):
    """Device time per call of each group of kernels of ``fn`` whose
    name contains one of ``names`` (summed over the group's launches in
    a call), from one profiler window of ``reps`` calls; 'all' is every
    device event of the call and 'events' their number a call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = device_events(fn, reps)
    out = {name: sum(e.time_range.end - e.time_range.start for e in evs
                     if name in e.name) / 1e3 / reps for name in names}
    out['all'] = sum(e.time_range.end - e.time_range.start
                     for e in evs) / 1e3 / reps
    out['events'] = len(evs) / reps
    return out


def check_order(tgt, num_segments, what):
    """The kernels' radix ordering of the targets against its plain
    version, ``segment_order``: perm and offsets equal exactly."""
    import torch
    from ch_shrinkwrap_torch.ops import cuda_scatter
    t = tgt.long()
    key = torch.where((t >= 0) & (t < num_segments), t, num_segments).int()
    perm, offsets = cuda_scatter.segment_order(key, num_segments)
    p2, o2 = cuda_scatter.radix_order(tgt, num_segments)
    n_p = int((p2.long() != perm).sum())
    n_o = int((o2 != offsets).sum())
    check(n_p == 0 and n_o == 0, f'{what}: the radix ordering differs from '
          f'segment_order ({n_p} of perm, {n_o} of offsets)')
    return dict(perm_differ=n_p, offsets_differ=n_o)


def bound_ms(n_bytes, n_flops):
    """Least time the card could take: max of bytes over the HBM rate
    and fp32 operations over the fp32 peak.  Returns (ms, bound_by)."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    tf = n_flops / FP32_FLOPS_PER_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def nbytes(*tensors):
    return int(sum(t.numel() * t.element_size() for t in tensors))


def to_cpu(args):
    import torch
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def bits_differ(a, b):
    """How many values of two float tensors of one shape differ in
    their bits (on the CPU; NaN payloads and signed zeros count)."""
    import torch
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    check(a.shape == b.shape and a.dtype == b.dtype,
          f'bits_differ: {a.shape} {a.dtype} against {b.shape} {b.dtype}')
    as_int = torch.int64 if a.element_size() == 8 else torch.int32
    return int((a.view(as_int) != b.view(as_int)).sum())


def digest(*arrays):
    """sha256 of the arrays' types, shapes and bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def library_index_add(timer, out, index, rows, ours):
    """One library call for an ordered segment sum: ``index_add_`` of
    the same rows into ``out``, under torch's deterministic mode
    (``library_ms``; the mode is restored afterwards) and as it runs by
    default, with float atomics (``library_racing_ms``), and how many
    values of the deterministic result differ in bits from ``ours``."""
    import torch
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det_ms = timer(lambda: out.index_add_(0, index, rows))['ms']
        det = torch.zeros_like(out).index_add_(0, index, rows)
    finally:
        torch.use_deterministic_algorithms(prev)
    return dict(library_ms=det_ms,
                library_racing_ms=timer(
                    lambda: out.index_add_(0, index, rows))['ms'],
                library_bits_differ=bits_differ(det, ours))


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


def phase_host_engine():
    """Build (when not yet built) and load the native host engine that
    every fit's remesh, tables and surgery run on; fails the run when
    it cannot be built or loaded (there is no fallback to switch to)."""
    from ch_shrinkwrap_torch import native
    built = not native._lib_current()
    t0 = time.time()
    try:
        native.get_lib()
        err = None
    except RuntimeError as e:
        err = str(e)
    build_s = time.time() - t0
    check(err is None, f'host engine: {err}')
    gxx = subprocess.run(['g++', '--version'], capture_output=True,
                         text=True, timeout=30, check=True)
    return {'engine': 'native', 'built': built,
            'build_s': round(build_s, 3), 'lib': native._LIB,
            'gxx': repr(gxx.stdout.strip().splitlines()[0])}


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
    # S has 3 columns a search direction: 3 directions, or 4 with the
    # shrink prior
    gathers = {'tri': (f, tables.tri_idx),
               'ncc': (torch.cat([f, vn], 1), tables.ncc_idx),
               'S': (torch.randn((Vp, 9), generator=g, device=dev),
                     tables.tri_idx),
               'S12': (torch.randn((Vp, 12), generator=g, device=dev),
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


# the evaluation sweep's ERSim entry (configs/test_ersim.yaml): ~19.7k
# localizations against its blocks' 'final' capacity of 70,656 padded faces
BRUTE_N, BRUTE_FP = 19_700, 70_656


def brute_case(device, n_points=BRUTE_N, n_faces=BRUTE_FP, seed=0):
    """Brute-force search inputs: a noisy R = 500 nm sphere cloud
    against face centres on the same sphere, every 11th face masked and
    the last 30% masked (a capacity's padding).  Returns (points,
    centers, f_mask)."""
    import torch
    rng = np.random.default_rng(seed)

    def sphere(n, sigma):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1)[:, None]
        return (d * RADIUS + rng.normal(scale=sigma, size=(n, 3))).astype(
            np.float32)

    mask = np.ones(n_faces, bool)
    mask[3::11] = False
    mask[int(0.7 * n_faces):] = False
    dev = torch.device(device)
    return (torch.from_numpy(sphere(n_points, SIGMA)).to(dev),
            torch.from_numpy(sphere(n_faces, 1.0)).to(dev),
            torch.from_numpy(mask).to(dev))


def brute_tie_case(device, n_points=300, n_faces=8525):
    """Brute-force inputs whose minima are exact ties: pairs of faces
    with one centre, the pairs placed on the seams of the built kernel's
    schedule (``cuda_brute.schedule()``) and of its face splits at this
    shape (``cuda_brute.splits``): within a chunk, across a chunk, two
    thread groups' spans, a staging tile and a split, an earlier group
    of a later tile against a later group of an earlier tile, the last
    two faces; in two pairs the lower face is masked.  Every other face
    lies 1e5 nm away; the points sit within 1 nm of their pair's
    centre, several points a pair, and span two point tiles.  Returns
    (points, centers, f_mask, expected idx): the lower valid face of
    each point's pair."""
    import torch
    from ch_shrinkwrap_torch.ops import cuda_brute
    dev = torch.device(device)
    _, tile, group_span, chunk, _ = cuda_brute.schedule()
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = -(-n_faces // cuda_brute.splits(n_points, n_faces, n_sms))
    span = -(-per // tile) * tile
    check(2 * span < n_faces, f'brute ties: one split ({span} faces)')
    pairs = [(17, 18), (5 * chunk - 1, 5 * chunk),
             (group_span - 1, group_span), (tile - 1, tile),
             (3 * group_span + 2, tile + 2), (span - 1, span),
             (9, span + 9), (span + 700, 2 * span + 3),
             (n_faces - 2, n_faces - 1)]
    masked = [(100, 101), (span - 5, span + 20)]
    ids = [f for pr in pairs + masked for f in pr]
    check(len(set(ids)) == len(ids), 'brute ties: pairs overlap')
    rng = np.random.default_rng(5)
    d = rng.normal(size=(n_faces, 3))
    cen = d / np.linalg.norm(d, axis=1)[:, None] * 1e5
    mask = np.ones(n_faces, bool)
    pts, want = [], []
    for k, (a, b) in enumerate(pairs + masked):
        c = np.array([200.0 * k - 900.0, 37.25, -12.5])
        cen[a] = cen[b] = c
        if (a, b) in masked:
            mask[a] = False
        n = n_points // len(pairs + masked) + (
            k < n_points % len(pairs + masked))
        pts.append(c + rng.uniform(-1.0, 1.0, (n, 3)))
        want += [b if (a, b) in masked else a] * n
    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    return (t(np.vstack(pts), np.float32), t(cen, np.float32),
            t(mask, bool), t(want, np.int32))


def brute_lattice_case(device, n_points=5000, n_faces=9000, seed=0):
    """Brute-force inputs on an integer lattice: points and centres with
    small integer coordinates, so every distance is an exact integer and
    most minima are ties among many faces; every 7th face masked."""
    import torch
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    mask = np.ones(n_faces, bool)
    mask[2::7] = False
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(-4, 5, (n_points, 3)).astype(np.float32),
        rng.integers(-4, 5, (n_faces, 3)).astype(np.float32), mask))


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
    t_start = time.time()

    def progress(what):
        print(f'  kernels: {what} at {time.time() - t_start:.1f} s',
              flush=True)

    inp = path_inputs(device, n_points, mesh_fn)
    dev, N, Fp, Vp, W = inp.dev, inp.N, inp.Fp, inp.Vp, inp.W
    recs = {}
    progress('inputs')

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

    progress('K1')

    # ---- K2: the path's rows, and rows outside every window ----------
    # each mode against its plain version on a CPU copy of the same
    # inputs: equal bit for bit (both add each face's rows in ascending
    # row index); the ordering against segment_order; the library call
    # is index_add_ of the mode's rows, under torch's deterministic mode
    # and, beside it, racing
    vals = torch.randn((N, 12), generator=inp.g, device=dev)
    fid_adv = adversarial_rows(inp)
    k2_bits, k2 = {}, {}
    for rows_name, fid in (('path', inp.fid), ('adversarial', fid_adv)):
        tgt = cuda_scatter.route(fid, inp.js, inp.meta_starts, inp.sub_ids,
                                 W, 256, False)
        n_out = int((tgt != fid.long()).sum())
        if rows_name == 'path':
            check(n_out == 0, f'K2: {n_out} path rows leave their face')
        else:
            check(n_out > 0, 'K2: no adversarial row outside every window')
        order = check_order(tgt, Fp, f'K2 {rows_name} rows')
        keep = (tgt >= 0) & (tgt < Fp)
        longest = int(torch.bincount(tgt[keep], minlength=Fp).max())
        for mode in ('ah', 'ahw2', 'w2', 'given'):
            args = (mode, inp.w, inp.res if mode in ('ah', 'ahw2') else None,
                    vals if mode == 'given' else None, fid, inp.js,
                    inp.meta_starts, inp.sub_ids, Fp)
            out = cuda_scatter.windowed_scatter(*args)
            ref = cuda_scatter.windowed_scatter_plain(*to_cpu(args))
            n_bits = bits_differ(out, ref)
            check(n_bits == 0, f'K2 {mode} on {rows_name} rows: {n_bits} '
                  f'values differ from the plain version in bits (max '
                  f'{float((out.cpu() - ref).abs().max())})')
            again = cuda_scatter.windowed_scatter(*args)
            check(bits_differ(out, again) == 0,
                  f'K2 {mode} on {rows_name} rows: two launches differ')
            k2_bits[f'{rows_name}_{mode}'] = n_bits
        ah = ('ah', inp.w, inp.res, None, fid, inp.js, inp.meta_starts,
              inp.sub_ids, Fp)
        rows = cuda_scatter._columns('ah', inp.w, inp.res, None)
        rows_k, tgt_k = rows[keep].contiguous(), tgt[keep].contiguous()
        lib_out = torch.zeros((Fp, 12), device=dev)
        t2 = timer(lambda: cuda_scatter.windowed_scatter(*ah))
        stages = device_stages(lambda: cuda_scatter.windowed_scatter(*ah),
                               K2_STAGES)
        print(f'  K2 {rows_name} rows (longest segment {longest}): '
              + json.dumps({k: round(v, 5) for k, v in stages.items()}),
              flush=True)
        k2[rows_name] = dict(
            ms=t2['ms'], call_ms=t2['call_ms'], rows_outside=n_out,
            longest_segment=longest, stages=stages,
            reduce_ms=stages['windowed_reduce'], **order,
            # the plain version on the card is a loop of small launches
            # (one step a row of the longest segment): its wall, from
            # CUDA events, not a profile of thousands of events
            plain_ms=time_ms(lambda: cuda_scatter.windowed_scatter_plain(
                *ah), reps=3, warmup=1),
            **library_index_add(timer, lib_out, tgt_k, rows_k,
                                cuda_scatter.windowed_scatter(*ah)))
    # the reduce alone against the longest segment: the path's rows with
    # the first L rows moved onto one face, L up to every row
    sweep_L = {}
    for L in (1, 169, 942, 44_839, N):
        fid_L = inp.fid.clone()
        fid_L[:L] = 7
        starts_L = inp.meta_starts.clone()
        starts_L[:-(-L // 256), 0] = 0
        args_L = ('ah', inp.w, inp.res, None, fid_L, inp.js, starts_L,
                  inp.sub_ids, Fp)
        out = cuda_scatter.windowed_scatter(*args_L)
        n_bits = bits_differ(out, cuda_scatter.windowed_scatter_plain(
            *to_cpu(args_L)))
        check(n_bits == 0, f'K2 with {L} rows on one face: {n_bits} values '
              f'differ from the plain version in bits')
        st = device_stages(lambda: cuda_scatter.windowed_scatter(*args_L),
                           K2_STAGES, reps=5, warmup=1)
        sweep_L[L] = dict(all_ms=st['all'], reduce_ms=st['windowed_reduce'])
    print('  K2 reduce against the longest segment: '
          + json.dumps({L: {k: round(v, 5) for k, v in r.items()}
                        for L, r in sweep_L.items()}), flush=True)
    k2_bytes = (nbytes(inp.w, inp.res, inp.fid, inp.js, inp.meta_starts,
                       inp.sub_ids) + Fp * 12 * 4)
    bms, bby = bound_ms(k2_bytes, 24.0 * N)
    recs['K2'] = dict(
        name='windowed_scatter', route='cuda',
        source='ch_shrinkwrap_torch/csrc/scatter.cu',
        replaces='JAX package ops/pallas_scatter.py:44 _scatter_kernel',
        max_abs_err=0.0, ms=k2['path']['ms'],
        call_ms=k2['path']['call_ms'], plain_ms=k2['path']['plain_ms'],
        bound_ms=bms, bound_by=bby, library_ms=k2['path']['library_ms'],
        checks=dict(path={k: v for k, v in k2['path'].items()
                          if k not in ('ms', 'call_ms', 'plain_ms')},
                    adversarial=k2['adversarial'], longest_sweep=sweep_L,
                    **{f'bits_differ_{k}': v for k, v in k2_bits.items()}))

    progress('K2')

    # ---- the ordered segment sum: the fit's other accumulations -------
    # vertex normals' corner rows (3 Fp, 3) onto the vertices (timed),
    # the fold's (3 Fp, 7) corner rows, the brute-force search's A^T
    # rows (N, 12) onto the faces, the fold's overflow onto a table
    # (init), and the corner rows all on one vertex: each equal, bit for
    # bit, to the plain version on a CPU copy
    from ch_shrinkwrap_torch.ops import normals
    ma = inp.ma
    corners = normals.vertex_normal_corners(ma.positions, ma.faces,
                                            ma.f_mask).reshape(-1, 3)
    faces_t = ma.faces.reshape(-1)
    ah_rows = cuda_scatter._columns('ah', inp.w, inp.res, None)
    init = torch.randn((Vp, 7), generator=inp.g, device=dev)
    one_face = torch.full_like(faces_t, 11)
    cases = {'normals': (corners, faces_t, Vp, None),
             'fold': (inp.fused, faces_t, Vp, None),
             'brute_ah': (ah_rows, inp.fid, Fp, None),
             'fold_init': (inp.fused, faces_t, Vp, init),
             'one_vertex': (corners, one_face, Vp, None)}
    seg_bits, seg_stages = {}, {}
    for key, (rows, tgt, S, ini) in cases.items():
        out = cuda_scatter.segment_sum_ordered(rows, tgt, S, init=ini)
        ref = cuda_scatter.segment_sum_ordered_plain(
            *to_cpu((rows, tgt, S)), init=None if ini is None else ini.cpu())
        n_bits = bits_differ(out, ref)
        check(n_bits == 0, f'segment_sum_ordered {key}: {n_bits} values '
              f'differ from the plain version in bits')
        check(bits_differ(out, cuda_scatter.segment_sum_ordered(
            rows, tgt, S, init=ini)) == 0,
            f'segment_sum_ordered {key}: two launches differ')
        seg_bits[key] = n_bits
        if key in ('normals', 'brute_ah', 'one_vertex'):
            tl_ = tgt.long()
            longest = int(torch.bincount(tl_[(tl_ >= 0) & (tl_ < S)],
                                         minlength=S).max())
            st = device_stages(lambda: cuda_scatter.segment_sum_ordered(
                rows, tgt, S), K2S_STAGES)
            seg_stages[key] = dict(longest_segment=longest, **st,
                                   **check_order(tgt, S, f'K2s {key}'))
            print(f'  K2s {key} (longest segment {longest}): '
                  + json.dumps({k: round(v, 5) for k, v in st.items()}),
                  flush=True)
    step = cuda_scatter.segment_sum_stepwise(corners, faces_t, Vp)
    check(bits_differ(step, cuda_scatter.segment_sum_ordered(
        corners, faces_t, Vp)) == 0,
        'segment_sum_ordered: the plain version on the card differs')
    tl = faces_t.long()
    ts = timer(lambda: cuda_scatter.segment_sum_ordered(corners, faces_t,
                                                        Vp))
    lib_out = torch.zeros((Vp, 3), device=dev)
    rec_s = dict(
        ms=ts['ms'], call_ms=ts['call_ms'],
        kernel_ms=seg_stages['normals']['segment_reduce'],
        plain_ms=time_ms(lambda: cuda_scatter.segment_sum_ordered_plain(
            corners, faces_t, Vp), reps=5, warmup=1),
        longest_segment=seg_stages['normals']['longest_segment'],
        **library_index_add(timer, lib_out, tl, corners,
                            cuda_scatter.segment_sum_ordered(
                                corners, faces_t, Vp)))
    tb = timer(lambda: cuda_scatter.segment_sum_ordered(ah_rows, inp.fid,
                                                        Fp))
    bms, bby = bound_ms(nbytes(corners, faces_t) + Vp * 3 * 4,
                        float(corners.numel()))
    recs['segsum'] = dict(
        name='segment_sum_ordered', route='cuda',
        source='ch_shrinkwrap_torch/csrc/scatter.cu',
        replaces='JAX package ops/pallas_scatter.py:44 _scatter_kernel '
                 '(its reduction, for the index_add_ sites)',
        max_abs_err=0.0, ms=rec_s['ms'], call_ms=rec_s['call_ms'],
        plain_ms=rec_s['plain_ms'], bound_ms=bms, bound_by=bby,
        library_ms=rec_s['library_ms'],
        checks=dict(normals={k: v for k, v in rec_s.items()
                             if k not in ('ms', 'call_ms', 'plain_ms')},
                    stages=seg_stages,
                    brute_ah_ms=tb['ms'], brute_ah_call_ms=tb['call_ms'],
                    **{f'bits_differ_{k}': v for k, v in seg_bits.items()}))

    progress('segment_sum_ordered')

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
                     src, 0, idx64))['ms'],
                 bound_ms=bound_ms(nbytes(src, idx, out), 0.0)[0])
        per_call[key] = {k: round(v, 5) for k, v in r.items()}
        if key == 'S12':
            # the shrink prior's S, beside the 9-column row; the K3 row
            # stays one iteration without the prior
            continue
        for k, v in r.items():
            if k != 'bound_ms':
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
        checks=dict(per='one iteration: tri + ncc + S gathers (S12: the '
                        'shrink prior\'s S, not in the sum)',
                    **per_call))

    progress('K3')

    # ---- K3f: the fold's fused gather + masked group sum --------------
    t = inp.tables
    fused, faces_l = inp.fused, inp.ma.faces.reshape(-1).long()
    out = cuda_gather.row_group_sum(fused, t.fold_idx, t.fold_care)
    ref = cuda_gather.row_group_sum_plain(fused, t.fold_idx, t.fold_care)
    err = float((out - ref).abs().max())
    # the kernel and its plain version add k = 0..K-1 in order
    n_bits = bits_differ(out, ref)
    check(n_bits == 0, f'K3f: {n_bits} values differ from its plain '
          f'version in bits (max {err})')
    fold = _fold(fused, inp.ma.faces, Vp, t)
    fold_ref = _fold(fused, inp.ma.faces, Vp, None)
    fold_err = float((fold - fold_ref).abs().max())
    check(fold_err <= 1e-4 * float(fold_ref.abs().max()),
          f'K3f fold vs the ordered segment sum: {fold_err}')
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
                    fold_bits_differ=bits_differ(fold, fold_ref),
                    gather_mask_sum_ms=timer(gather_mask_sum)['ms'],
                    fold_ms=timer(lambda: _fold(fused, inp.ma.faces, Vp,
                                                t))['ms']))
    progress('K3f')

    # ---- the seed's density field ------------------------------------
    # the kernel against the host engine and against its plain version
    # on the card, bit for bit, with the same live queries; ms is all
    # the device work of a call (binning, ordering, search), search_ms
    # the search kernel alone; host_ms the engine's wall on this host
    from ch_shrinkwrap_torch import native
    from ch_shrinkwrap_torch.mesh.marching import grid_nodes, seed_grid
    from ch_shrinkwrap_torch.ops import cuda_field
    cloud, _ = sphere_cloud(n_points)
    bbox, step, bound = seed_grid(cloud, 25.0, 48)
    q_np = grid_nodes(bbox, step)[1].astype(np.float32)
    cloud_d = torch.from_numpy(cloud).to(dev)
    q_d = torch.from_numpy(q_np).to(dev)
    live = torch.empty(len(q_np), dtype=torch.bool, device=dev)
    field = cuda_field.knn_field(cloud_d, q_d, 50, bound, live=live)
    t0 = time.perf_counter()
    ref = native.knn_field(cloud, q_np, 50, bound)
    host_ms = (time.perf_counter() - t0) * 1e3
    n_host = bits_differ(field, torch.from_numpy(ref))
    check(n_host == 0, f'field: {n_host} values differ from the host '
          f'engine in bits')
    live_p = torch.empty_like(live)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = cuda_field.knn_field_plain(cloud_d, q_d, 50, bound, live=live_p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_plain = bits_differ(field, plain)
    check(n_plain == 0 and torch.equal(live, live_p),
          f'field: {n_plain} values differ from the plain version in bits, '
          f'live equal: {torch.equal(live, live_p)}')
    tf = timer(lambda: cuda_field.knn_field(cloud_d, q_d, 50, bound))
    ts = timer(lambda: cuda_field.knn_field(cloud_d, q_d, 50, bound),
               match='knn_field_kernel')
    bms, bby = bound_ms(nbytes(cloud_d, q_d, field), 0.0)
    recs['field'] = dict(
        name='knn_field', route='cuda',
        source='ch_shrinkwrap_torch/csrc/knn_field.cu',
        replaces='no Pallas kernel: the host engine native.knn_field '
                 '(native/topology.cpp)',
        max_abs_err=0.0, ms=tf['ms'], call_ms=tf['call_ms'],
        plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
        checks=dict(host_ms=host_ms, search_ms=ts['ms'],
                    bits_differ_host=n_host, bits_differ_plain=n_plain,
                    N=n_points, queries=len(q_np), k=50, bound=bound,
                    live=int(live.sum()),
                    misses=int((field == 2 * np.float32(bound)).sum())))
    progress('field')

    # ---- the brute-force search ---------------------------------------
    # the kernel against its plain version on the card at the sweep's
    # shape, with ties on the schedule's seams and on a lattice; ms is
    # all the device work of a call (table, search, merge),
    # search_ms the search kernel alone; plain_ms the plain version's
    # wall on the card and plain_launches its device events a search
    from ch_shrinkwrap_torch.ops import cuda_brute
    bargs = brute_case(dev)
    bk = cuda_brute.brute_min(*bargs)
    bp = cuda_brute.brute_min_plain(*bargs)
    n_bd = bits_differ(bk[0], bp[0])
    n_bi = int((bk[1] != bp[1]).sum())
    check(n_bd == 0 and n_bi == 0, f'brute: {n_bi} ids and {n_bd} '
          f'distances differ from the plain version in bits')
    *tie_args, want = brute_tie_case(dev)
    for fn in (cuda_brute.brute_min, cuda_brute.brute_min_plain):
        n_tie = int((fn(*tie_args)[1] != want).sum())
        check(n_tie == 0, f'brute ties ({fn.__name__}): {n_tie} points '
              f'not matched to the lowest valid id of their pair')
    lat = brute_lattice_case(dev)
    for a_, b_ in zip(cuda_brute.brute_min(*lat),
                      cuda_brute.brute_min_plain(*lat)):
        check(bits_differ(a_, b_) == 0,
              'brute lattice ties: kernel and plain version differ')
    N_b, Fp_b = bargs[0].shape[0], bargs[1].shape[0]
    tb = timer(lambda: cuda_brute.brute_min(*bargs))
    tbs = timer(lambda: cuda_brute.brute_min(*bargs),
                match='brute_min_kernel')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cuda_brute.brute_min_plain(*bargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_launches = len(device_events(
        lambda: cuda_brute.brute_min_plain(*bargs), 1))
    # FMUL, 2 FFMA, 2 FADD and 1 FMNMX a pair, an FFMA counted as two
    bms, bby = bound_ms(nbytes(*bargs, bk[0], bk[1]), 8.0 * N_b * Fp_b)
    recs['brute'] = dict(
        name='brute_min', route='cuda',
        source='ch_shrinkwrap_torch/csrc/brute.cu',
        replaces="no Pallas kernel: the JAX package's jitted lax.scan "
                 "(ops/correspondence.py nearest_face_bruteforce)",
        max_abs_err=0.0, ms=tb['ms'], call_ms=tb['call_ms'],
        plain_ms=plain_ms, bound_ms=bms, bound_by=bby, library_ms=None,
        checks=dict(search_ms=tbs['ms'], events=tb['launches'],
                    plain_launches=plain_launches,
                    bits_differ_dist=n_bd, ids_differ=n_bi, N=N_b,
                    Fp=Fp_b, valid=int(bargs[2].sum()),
                    splits=cuda_brute.splits(
                        N_b, Fp_b, torch.cuda.get_device_properties(
                            dev).multi_processor_count)))
    progress('brute')
    return recs


def bench_inputs(device='cuda', n_points=N_POINTS, ico_sub=7):
    """The bench configuration's block inputs: the sorted 1e6-point
    cloud and icosphere(7) at r = 550, padded as the fit pads."""
    import torch
    from types import SimpleNamespace
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.ops import meshdata
    from ch_shrinkwrap_torch.ops.ordering import fit_point_order
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
    return SimpleNamespace(
        dev=dev, ma=ma, tables=tables, pts=pts, sigma_inv=sigma_inv,
        weights=weights, pts_t=torch.from_numpy(pts).to(dev),
        sig_t=torch.from_numpy(sigma_inv).to(dev),
        w_t=torch.from_numpy(weights).to(dev),
        pm=torch.ones(n_points, dtype=torch.bool, device=dev),
        face_hcgc=ma.positions.shape[0] > meshdata.HCGC_MIN_VP)


def phase_cg_block(device='cuda', n_points=N_POINTS, ico_sub=7, rf=5,
                   n_blocks=3):
    """The bench configuration: 1e6 points, icosphere(7) at r = 550,
    rf = 5, n_blocks timed blocks after one warm-up block, then one
    block under torch.profiler.  Returns (readings, profiler table)."""
    import torch
    from ch_shrinkwrap_torch.solver.shrinkwrap import cg_block
    from ch_shrinkwrap_torch.utils.tracing import device_profile
    b = bench_inputs(device, n_points, ico_sub)
    dev, ma = b.dev, b.ma

    def block(pos):
        return cg_block(pos, ma.faces, ma.f_mask, ma.v_mask, ma.nbr_v,
                        b.pts_t, b.sig_t, b.w_t, b.pm, 2.0, num_iters=rf,
                        corr_method='windowed', face_nbrs=ma.face_nbrs,
                        tables=b.tables, face_hcgc=b.face_hcgc)

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


# the kernels of the windowed fit at its capacity (the fit, fit99,
# image and shard phases): every fold runs through K3f, and no vertex of
# their meshes has more incident faces or neighbours than the tables
# hold, so segment_sum_ordered has no work there; it carries the
# brute-force search's A^T scatter and the fold without tables, the
# path of the sweep phase (and of fit.punch)
WINDOWED_PATH = ('K1', 'K2', 'K3', 'K3f')


def kernel_wrappers():
    """The seven kernel wrappers, whose ``launches`` count kernel
    launches."""
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_brute, cuda_field, cuda_gather
    return {'K1': cuda_window.window_min,
            'K2': cuda_scatter.windowed_scatter,
            'segsum': cuda_scatter.segment_sum_ordered,
            'K3': cuda_gather.row_gather,
            'K3f': cuda_gather.row_group_sum,
            'field': cuda_field.knn_field,
            'brute': cuda_brute.brute_min}


@contextlib.contextmanager
def plain_versions():
    """Route the fit's path through each kernel's plain PyTorch version
    (the reference run held against the kernels on the same card)."""
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_brute, cuda_field, cuda_gather
    from ch_shrinkwrap_torch.solver import shrinkwrap
    saved = (cuda_window.window_min, cuda_scatter.windowed_scatter,
             cuda_scatter.segment_sum_ordered, shrinkwrap.row_gather,
             shrinkwrap.row_group_sum, cuda_field.knn_field,
             cuda_brute.brute_min)
    cuda_window.window_min = cuda_window.window_min_plain
    cuda_scatter.windowed_scatter = cuda_scatter.windowed_scatter_plain
    cuda_scatter.segment_sum_ordered = cuda_scatter.segment_sum_ordered_plain
    shrinkwrap.row_gather = cuda_gather.row_gather_plain
    shrinkwrap.row_group_sum = cuda_gather.row_group_sum_plain
    cuda_field.knn_field = cuda_field.knn_field_plain
    cuda_brute.brute_min = cuda_brute.brute_min_plain
    try:
        yield
    finally:
        (cuda_window.window_min, cuda_scatter.windowed_scatter,
         cuda_scatter.segment_sum_ordered, shrinkwrap.row_gather,
         shrinkwrap.row_group_sum, cuda_field.knn_field,
         cuda_brute.brute_min) = saved


def phase_fit(device='cuda', n_points=N_POINTS, grid_n=48, iters=20,
              radius=RADIUS, corr_method='auto', devices=None):
    """The no-surgery fit (20 iterations by default) from the marching
    seed, as a user runs it; with ``devices``, the same fit through
    ``sharded_fit`` with one rank a device."""
    import torch
    from ch_shrinkwrap_torch.mesh.marching import wrap_start
    from ch_shrinkwrap_torch.models import MembraneMesh
    from ch_shrinkwrap_torch.parallel.sharding import sharded_fit
    pts, sig = sphere_cloud(n_points, radius=radius)
    t0 = time.time()
    surf = wrap_start(pts, offset=25.0, grid_n=grid_n, device=device)
    t_seed = time.time() - t0
    mesh = MembraneMesh(
        mesh=surf, kc=1.0, step_size=20.0, max_iter=iters,
        remesh_frequency=5, delaunay_remesh_frequency=0,
        neck_first_iter=-1, device=device)
    mesh.corr_method = corr_method
    V0 = int(mesh.vertices.shape[0])
    t1 = time.time()
    if devices is None:
        mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                         minimum_edge_length=5.0)
    else:
        sharded_fit(mesh, pts, sig, devices=devices,
                    method='conjugate_gradient', minimum_edge_length=5.0)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    t_fit = time.time() - t1
    r = np.linalg.norm(mesh.vertices, axis=1)
    _, n_comp = mesh.connected_components()
    out = dict(seed_s=t_seed, fit_s=t_fit, V0=V0,
               V=int(mesh.vertices.shape[0]),
               R_mean=float(r.mean()), R_std=float(r.std()),
               euler=int(mesh.euler_characteristic),
               manifold=bool(mesh.is_manifold), components=int(n_comp),
               method=mesh._last_corr_method,
               sha_vertices=digest(mesh.vertices),
               sha_faces=digest(mesh.faces),
               trace=[(rec.kind, rec.iteration, round(rec.wall_time, 3),
                       rec.n_vertices, rec.extra.get('v_cap', ''))
                      for rec in mesh.trace.records])
    if devices is not None:
        dm = mesh.device_mesh
        out.update(backend=dm.backend,
                   devices=[str(d) for d in dm.devices],
                   in_step_checks=sum(rec.kind == 'in_step'
                                      for rec in mesh.trace.records),
                   blocks=sum(rec.kind == 'cg_block'
                              for rec in mesh.trace.records),
                   diag_rows=int(mesh._last_diag.res.shape[0]))
    return out


def check_fit(fit, radius=RADIUS, mean_tol=1.5, tag='fit'):
    check(abs(fit['R_mean'] - radius) < mean_tol,
          f"{tag} |R - {radius}| = {abs(fit['R_mean'] - radius)} "
          f">= {mean_tol}")
    check(fit['R_std'] < 1.5, f"{tag} R std {fit['R_std']}")
    check(fit['euler'] == 2, f"{tag} euler {fit['euler']}")
    check(fit['manifold'], f'{tag} mesh not manifold')
    check(fit['components'] == 1, f"{tag} components {fit['components']}")


def same_bits(a, b):
    """Whether two fits' final meshes are equal bit for bit."""
    return (a['sha_vertices'] == b['sha_vertices']
            and a['sha_faces'] == b['sha_faces'])


def check_same_fit(fit, ref):
    """The kernel path against the plain path on the same card: the
    same surface (on an H100, when K2 and index_add_ still added with
    float atomics, the two paths differed by up to 0.06 nm in R and
    0.2% in vertex count over four runs), and whether it is the same
    bit for bit."""
    d_mean = abs(fit['R_mean'] - ref['R_mean'])
    d_std = abs(fit['R_std'] - ref['R_std'])
    d_v = abs(fit['V'] - ref['V']) / ref['V']
    check(d_mean < 0.2, f'fit vs plain: |dR| = {d_mean} nm')
    check(d_std < 0.1, f'fit vs plain: |d std| = {d_std} nm')
    check(d_v < 0.02, f'fit vs plain: vertex counts differ by {d_v:.3%}')
    return dict(dR=d_mean, dstd=d_std, dV=d_v,
                bit_identical=same_bits(fit, ref))


def phase_fit99(device='cuda', n_points=N_POINTS, radius=RADIUS,
                grid_n=48, iters=99, punch_frequency=13,
                neck_first_iter=9, min_edge=5.0):
    """The north-star fit (scripts/torch_e2e_fit.py's defaults) from
    the marching seed: remesh every 5, neck removal after
    ``neck_first_iter`` at -1e-3 / 1e-2, punching every
    ``punch_frequency`` with a 100 nm minimum hole radius."""
    import torch
    from ch_shrinkwrap_torch.mesh.marching import wrap_start
    from ch_shrinkwrap_torch.models import MembraneMesh
    pts, sig = sphere_cloud(n_points, radius=radius)
    t0 = time.time()
    surf = wrap_start(pts, offset=25.0, grid_n=grid_n, device=device)
    t_seed = time.time() - t0
    mesh = MembraneMesh(
        mesh=surf, kc=1.0, step_size=20.0, max_iter=iters,
        remesh_frequency=5, delaunay_remesh_frequency=punch_frequency,
        delaunay_eps=100.0, neck_first_iter=neck_first_iter,
        neck_threshold_low=-1e-3, neck_threshold_high=1e-2,
        device=device)
    t1 = time.time()
    mesh.shrink_wrap(pts, sig, method='conjugate_gradient',
                     minimum_edge_length=min_edge)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    t_fit = time.time() - t1
    r = np.linalg.norm(mesh.vertices, axis=1)
    _, n_comp = mesh.connected_components()
    recs = mesh.trace.records
    wall = mesh.trace.wall_by_phase()
    host = t_fit - wall['block']
    return dict(seed_s=t_seed, fit_s=t_fit,
                host_s=host, host_share=host / t_fit,
                V=int(mesh.vertices.shape[0]),
                R_mean=float(r.mean()), R_std=float(r.std()),
                euler=int(mesh.euler_characteristic),
                manifold=bool(mesh.is_manifold), components=int(n_comp),
                method=mesh._last_corr_method,
                sha_vertices=digest(mesh.vertices),
                sha_faces=digest(mesh.faces),
                n_punched=sum(int(rec.extra.get('n_punched', 0))
                              for rec in recs),
                necks_removed=sum(int(rec.extra.get('necks_removed', 0))
                                  for rec in recs),
                wall=wall,
                trace=[(rec.kind, rec.iteration, round(rec.wall_time, 3),
                        rec.n_vertices,
                        {k: (round(v, 3) if isinstance(v, float) else v)
                         for k, v in rec.extra.items()})
                       for rec in recs])


def check_fit99(fit, launches, iters=99):
    check(abs(fit['R_mean'] - RADIUS) < 1.5,
          f"fit99 |R - {RADIUS}| = {abs(fit['R_mean'] - RADIUS)} >= 1.5")
    check(fit['R_std'] < 1.0, f"fit99 R std {fit['R_std']} >= 1.0")
    check(fit['euler'] == 2, f"fit99 euler {fit['euler']}")
    check(fit['manifold'], 'fit99 mesh not manifold')
    check(fit['components'] == 1, f"fit99 components {fit['components']}")
    check(launches['K1'] == iters,
          f"fit99: K1 launched {launches['K1']} times, not {iters}")
    for key in WINDOWED_PATH:
        check(launches[key] > 0, f'{key} was not launched during fit99')


def torus_cloud(R=40.0, r=10.0, n=8000, seed=0):
    """Points on a torus in the x-z plane (the JAX suite's punch
    fixture)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    x = (R + r * np.cos(v)) * np.cos(u)
    z = (R + r * np.cos(v)) * np.sin(u)
    y = r * np.sin(v)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def phase_punch(device='cuda', iters=25):
    """An oblate seed fitted to a torus cloud, punched at iteration 20
    inside the fit (eps 15 nm), then 5 iterations on the punched
    topology."""
    import torch
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.models import MembraneMesh
    pts = torus_cloud()
    v, f = icosphere(3, radius=1.0)
    v = v * np.array([55.0, 14.0, 55.0], np.float32)
    mesh = MembraneMesh(v, f, kc=1.0, step_size=4.0, remesh_frequency=0,
                        delaunay_remesh_frequency=20, delaunay_eps=15.0,
                        device=device)
    t0 = time.time()
    mesh.shrink_wrap(pts, 3.0, max_iter=iters)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    return dict(fit_s=time.time() - t0,
                n_punched=sum(int(rec.extra.get('n_punched', 0))
                              for rec in mesh.trace.records),
                euler=int(mesh.euler_characteristic),
                manifold=bool(mesh.is_manifold),
                V=int(mesh.vertices.shape[0]),
                trace=[(rec.kind, rec.iteration) for rec in
                       mesh.trace.records])


def check_punch(card, cpu):
    n = card['n_punched']
    check(n >= 1, 'fit.punch: nothing punched inside the loop')
    check(card['euler'] == 2 - 2 * n,
          f"fit.punch: euler {card['euler']} != 2 - 2 * {n}")
    check(card['manifold'], 'fit.punch: mesh not manifold')
    check(card['trace'][-1] == ('cg_block', 25),
          f"fit.punch: no block after the punch ({card['trace']})")
    check((cpu['n_punched'], cpu['euler']) == (n, card['euler']),
          f"fit.punch: the CPU run punched {cpu['n_punched']} "
          f"(euler {cpu['euler']}), the card {n} (euler {card['euler']})")


class VoxelImage:
    """The image ImageShrinkwrapMembrane reads: ``data`` (nx, ny, nz)
    weights, ``voxelsize_nm`` and ``origin``, the first voxel's
    centre."""

    def __init__(self, data, voxelsize_nm, origin):
        self.data = data
        self.voxelsize_nm = voxelsize_nm
        self.origin = origin


def cloud_image(pts, voxel=VOXEL):
    """3-D histogram of a cloud at ``voxel`` nm bins from its lowest
    corner, with the origin on the first bin's centre."""
    lo = pts.min(0).astype(np.float64)
    n = np.maximum(np.ceil((pts.max(0) - lo) / voxel).astype(int), 1)
    edges = [lo[k] + voxel * np.arange(n[k] + 1) for k in range(3)]
    data, _ = np.histogramdd(pts, bins=edges)
    return VoxelImage(data.astype(np.float32), (voxel,) * 3,
                      tuple(float(x) for x in lo + voxel / 2.0))


def phase_image(device='cuda', n_points=N_POINTS, radius=RADIUS,
                grid_n=48, iters=100, min_edge=5.0, voxel=VOXEL):
    """The image recipe with its defaults (the shrink prior at weight
    1) on a histogram of the sphere cloud, from the marching seed, with
    the north-star neck thresholds and a ``min_edge`` minimum edge."""
    import torch
    from ch_shrinkwrap_torch.mesh.marching import wrap_start
    from ch_shrinkwrap_torch.recipes.surface_fitting import \
        ImageShrinkwrapMembrane
    pts, _ = sphere_cloud(n_points, radius=radius)
    t0 = time.time()
    image = cloud_image(pts, voxel)
    t_image = time.time() - t0
    surf = wrap_start(pts, offset=25.0, grid_n=grid_n, device=device)
    t_seed = time.time() - t0 - t_image
    mod = ImageShrinkwrapMembrane(
        input='surf', input_image='image', output='membrane',
        max_iters=iters, neck_threshold_low=-1e-3,
        neck_threshold_high=1e-2, minimum_edge_length=min_edge,
        device=device)
    ns = {'surf': surf, 'image': image}
    t1 = time.time()
    mod.execute(ns)
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()
    t_fit = time.time() - t1
    mesh = ns['membrane']
    r = np.linalg.norm(mesh.vertices, axis=1)
    _, n_comp = mesh.connected_components()
    recs = mesh.trace.records
    wall = mesh.trace.wall_by_phase()
    host = t_fit - wall['block']
    return dict(image_s=t_image, seed_s=t_seed, fit_s=t_fit,
                host_s=host, host_share=host / t_fit,
                voxels=list(image.data.shape),
                n_pseudo=int((image.data > 0).sum()),
                V=int(mesh.vertices.shape[0]),
                R_mean=float(r.mean()), R_std=float(r.std()),
                euler=int(mesh.euler_characteristic),
                manifold=bool(mesh.is_manifold), components=int(n_comp),
                method=mesh._last_corr_method,
                directions=int(mesh._last_diag.S.shape[-1]),
                necks_removed=sum(int(rec.extra.get('necks_removed', 0))
                                  for rec in recs),
                sha_vertices=digest(mesh.vertices),
                sha_faces=digest(mesh.faces),
                wall=wall,
                trace=[(rec.kind, rec.iteration, round(rec.wall_time, 3),
                        rec.n_vertices, rec.extra.get('v_cap', ''))
                       for rec in recs])


def check_image(fit, launches, iters=100, voxel=VOXEL):
    check(abs(fit['R_mean'] - RADIUS) < voxel / 2,
          f"image |R - {RADIUS}| = {abs(fit['R_mean'] - RADIUS)} "
          f">= {voxel / 2}")
    check(fit['euler'] == 2, f"image euler {fit['euler']}")
    check(fit['manifold'], 'image mesh not manifold')
    check(fit['components'] == 1, f"image components {fit['components']}")
    check(fit['directions'] == 4,
          f"image: {fit['directions']} search directions, not 4")
    for key in ('K1', 'K2'):
        check(launches[key] == iters,
              f'image: {key} launched {launches[key]} times, not {iters}')
    for key in WINDOWED_PATH:
        check(launches[key] > 0,
              f'{key} was not launched during the image fit')


def _stl_digest(out):
    names = sorted(n for n in os.listdir(out) if n.endswith('.stl'))
    check(len(names) == 1, f'sweep: {len(names)} surfaces written')
    with open(os.path.join(out, names[0]), 'rb') as fh:
        return digest(np.frombuffer(fh.read(), np.uint8))


def phase_sweep(config=None, device='cuda', seed=0):
    """The evaluation harness on a sweep config (default
    configs/test_ersim.yaml), then the same sweep again in the same
    output directory, which must skip the finished entry, then the
    sweep with every kernel replaced by its plain version.  Returns the
    rows and the sha256 digest of each run's final surface (its STL
    file)."""
    import tempfile
    from ch_shrinkwrap_torch.eval.harness import evaluate
    if config is None:
        config = os.path.join(HERE, 'configs', 'test_ersim.yaml')
    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        rows = evaluate(config, out_dir=out, seed=seed, device=device,
                        save_stl=True)
        t1 = time.time()
        again = evaluate(config, out_dir=out, seed=seed, device=device)
        t2 = time.time()
        with open(os.path.join(out, 'metrics.jsonl')) as fh:
            n_lines = len(fh.read().splitlines())
        sha = _stl_digest(out)
    with tempfile.TemporaryDirectory() as out, plain_versions():
        t3 = time.time()
        plain_rows = evaluate(config, out_dir=out, seed=seed, device=device,
                              save_stl=True)
        t4 = time.time()
        plain_sha = _stl_digest(out)
    return dict(rows=rows, first_s=t1 - t0, restart_s=t2 - t1,
                restart_rows=len(again), n_lines=n_lines, sha_stl=sha,
                plain_rows=plain_rows, plain_s=t4 - t3,
                plain_sha_stl=plain_sha)


def check_sweep(sw, euler=0):
    check(len(sw['rows']) == 1 and sw['n_lines'] == 1,
          f"sweep: {len(sw['rows'])} rows, {sw['n_lines']} lines written "
          f"(an entry failed)")
    row = sw['rows'][0]
    check(row['euler'] == euler, f"sweep: euler {row['euler']}")
    check(row['components'] == 1, f"sweep: components {row['components']}")
    check(row['manifold'], 'sweep: mesh not manifold')
    check(row.get('topology_correct') is True,
          'sweep: topology_correct is not true')
    check(sw['restart_rows'] == 0, 'sweep: the restart did not skip the '
          'finished entry')
    # every kernel repeats its plain version's bits: the same surface
    # and the same row but for the fit's duration
    check(sw['sha_stl'] == sw['plain_sha_stl'],
          'sweep: the plain-routed fit gives another surface')
    plain = sw['plain_rows'][0] if sw['plain_rows'] else {}
    differ = sorted(k for k in set(row) | set(plain)
                    if k != 'duration' and row.get(k) != plain.get(k))
    check(not differ, f'sweep: the plain-routed row differs in {differ}')


# Phase grids: four sweep entries (configs/) that are correct in the
# JAX package's record and in every card run of scripts/torch_grids.py
# and of the phase's repeats (PERF.md section 6): the collapse veto
# with punching on two tori; a neck cut on two capsules (the separator
# rows of test_necks_separator.yaml and the one row of
# test_necks_separator_recipe.yaml flip between card runs, in the JAX
# package too: ROADMAP Queue C); the same row through the recipe route
# (``via_recipe``); the tetrahedron.  ``sdf_ref`` is the JAX package's
# sdf_rms on the entry on the CPU (eval_out_torch/jax_cpu/) and
# ``sdf_tol`` the bound on |sdf_rms - sdf_ref|.
GRID_ENTRIES = (
    dict(config='test_example_veto.yaml', entry='20f3f5f86d4b',
         sdf_ref=28.531, sdf_tol=0.32),
    dict(config='test_necks_separator.yaml', entry='7264048d1733',
         sdf_ref=10.521, sdf_tol=0.90),
    dict(config='test_necks_separator.yaml', entry='7264048d1733',
         via_recipe=True, sdf_ref=10.521, sdf_tol=0.90),
    dict(config='test_tetra.yaml', entry='15e069aae9d3',
         sdf_ref=14.793, sdf_tol=0.19),
)
# run twice at once beside GRID_ENTRIES: a separator row whose topology
# changed between card runs while the card's sums had no fixed order
# (ROADMAP Queue C.13); the two rows must be equal but for the fit's
# duration.  Its topology is printed and not gated: how the separator
# cuts this entry is the method's own sensitivity.
REPEAT_ENTRY = dict(config='test_necks_separator.yaml', entry='375680bfb943',
                    sdf_ref=None, sdf_tol=None)


def grid_entry(spec):
    """(sweep dict, entry hash) of a GRID_ENTRIES item; with
    ``via_recipe`` the same entry through the recipe route."""
    import yaml
    from ch_shrinkwrap_torch.eval import harness
    with open(os.path.join(HERE, 'configs', spec['config'])) as fh:
        test_d = yaml.safe_load(fh)
    sw, _ = harness.testing_parameters(test_d)
    hits = [p for p in sw if harness._param_hash(
        {'kind': 'shrinkwrap', **p}) == spec['entry']]
    check(len(hits) == 1,
          f"grids: {spec['config']} has no entry {spec['entry']}")
    if not spec.get('via_recipe'):
        return test_d, spec['entry']
    test_d['shrinkwrapping']['via_recipe'] = [True]
    return test_d, harness._param_hash(
        {'kind': 'shrinkwrap', **dict(hits[0], via_recipe=True)})


def phase_grids(entries=GRID_ENTRIES, device='cuda', timeout=110.0):
    """The chosen sweep entries through the harness, all at once, one
    spawned worker an entry (``evaluate(n_workers=1, entry_timeout=...,
    only=...)``), each counting the kernels' launches inside its
    worker.  Returns per entry its status, worker seconds, launches and
    metrics row (None when the entry wrote none)."""
    import tempfile
    from ch_shrinkwrap_torch.eval.harness import evaluate
    specs = [(spec, *grid_entry(spec)) for spec in entries]
    logs = [{} for _ in specs]
    rows = [None] * len(specs)
    errors = []
    with tempfile.TemporaryDirectory() as out:
        def one(i):
            spec, test_d, h = specs[i]
            try:
                got = evaluate(test_d, out_dir=os.path.join(out, str(i)),
                               seed=0, n_workers=1, entry_timeout=timeout,
                               device=device, entry_log=logs[i], only={h})
                rows[i] = got[0] if got else None
            except Exception as e:
                errors.append(f"{spec['config']}: {e!r}")

        pool = [threading.Thread(target=one, args=(i,))
                for i in range(len(specs))]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    check(not errors, f'grids: {errors}')
    out = []
    for (spec, _, h), log, row in zip(specs, logs, rows):
        info = log.get(h, {})
        out.append(dict(config=spec['config'], entry=h,
                        via_recipe=bool(spec.get('via_recipe')),
                        status=info.get('status', 'not run'),
                        wall_s=info.get('wall_s'),
                        launches=info.get('launches'), row=row,
                        sdf_ref=spec['sdf_ref'], sdf_tol=spec['sdf_tol']))
    return out


def check_repeat(results):
    """The REPEAT_ENTRY workers' rows: equal in every field but the
    fit's ``duration``.  Returns the fields that differ."""
    rows = [r['row'] for r in results]
    for r in results:
        check(r['row'] is not None, f"grids repeat {r['entry']}: no "
              f"metrics row ({r['status']})")
    differ = sorted(k for k in set(rows[0]) | set(rows[1])
                    if k != 'duration' and rows[0].get(k) != rows[1].get(k))
    check(not differ, f'grids repeat {results[0]["entry"]}: the two '
          f'workers\' rows differ in {differ}')
    return differ


def check_grids(results):
    for r in results:
        tag = f"grids {r['config']} {r['entry']}"
        row = r['row']
        check(row is not None, f"{tag}: no metrics row ({r['status']})")
        check(r['launches'] is not None, f'{tag}: no launch counts')
        check(row['manifold'], f'{tag}: mesh not manifold')
        check(row.get('topology_correct') is True,
              f"{tag}: euler {row['euler']}, {row['components']} "
              f"components, expected {row.get('expected_euler')}, "
              f"{row.get('expected_components')}")
        d = abs(row['sdf_rms'] - r['sdf_ref'])
        check(d <= r['sdf_tol'], f"{tag}: |sdf_rms - {r['sdf_ref']}| = "
              f"{d} > {r['sdf_tol']}")


def shard_devices():
    """Two ranks: one a card where the machine has two (NCCL), else
    both on cuda:0 (gloo)."""
    import torch
    if torch.cuda.device_count() >= 2:
        return ['cuda:0', 'cuda:1']
    return ['cuda:0', 'cuda:0']


def phase_shard_block(rf=5):
    """The bench configuration's CG block through ``sharded_cg_block``
    at world size 1 (NCCL) and 2, against the one-process block.  Gates:
    the first-iteration face ids equal and the first-iteration positions
    within 5e-3 (tests/test_parallel.py:37-38: only the reduction order
    differs), the same number of iterations done after ``rf``, and the
    mean radius after ``rf`` within 0.2 nm.  The largest position
    difference after ``rf`` is read beside that of a second one-process
    run, which must be zero: every sum of the block has one order.  At
    world size 1 the all-reduce is the identity, but the rank sums over
    its slice padded to whole 256-point blocks (1,000,192 rows), so the
    point-axis reductions group their terms otherwise; against the
    one-process block on that same padded cloud the positions must be
    equal bit for bit.  World size 2 runs the face-side normal
    equations, so W2 is all-reduced too."""
    from ch_shrinkwrap_torch.parallel.sharding import (make_device_mesh,
                                                       shard_points,
                                                       sharded_cg_block)
    from ch_shrinkwrap_torch.solver.shrinkwrap import cg_block
    b = bench_inputs()
    ma = b.ma
    N = b.pts.shape[0]
    vm = ma.v_mask.bool()

    def one(num_iters, face_hcgc):
        return cg_block(ma.positions, ma.faces, ma.f_mask, ma.v_mask,
                        ma.nbr_v, b.pts_t, b.sig_t, b.w_t, b.pm, 2.0,
                        num_iters=num_iters, corr_method='windowed',
                        face_nbrs=ma.face_nbrs, tables=b.tables,
                        face_hcgc=face_hcgc)

    def r_mean(f):
        return float(f[vm].norm(dim=1).mean())

    out = {}
    for devices, hcgc in ((['cuda:0'], b.face_hcgc),
                          (shard_devices(), True)):
        mesh = make_device_mesh(len(devices), devices)
        kw = dict(lam0=2.0, corr_method='windowed', face_nbrs=ma.face_nbrs,
                  tables=True, face_hcgc=hcgc)
        f_first, first = one(1, hcgc)
        f_one, d_one = one(rf, hcgc)
        f_one2, _ = one(rf, hcgc)
        f_s1, e_s = sharded_cg_block(mesh, ma, b.pts, b.sigma_inv,
                                     b.weights, num_iters=1, **kw)
        t0 = time.time()
        f_s, d_s = sharded_cg_block(mesh, ma, b.pts, b.sigma_inv,
                                    b.weights, num_iters=rf, **kw)
        wall = time.time() - t0
        n_ids = int((e_s.fi[:N] != first.fi).sum())
        err1 = float((f_s1 - f_first).abs().max())
        d_r = abs(r_mean(f_s) - r_mean(f_one))
        key = f'ws{mesh.world_size}'
        out[key] = dict(backend=mesh.backend, face_hcgc=hcgc,
                        ids_differ=n_ids, first_max_abs_dpos=err1,
                        n_done=int(d_s.n_done), n_done_one=int(d_one.n_done),
                        dR=d_r, max_abs_dpos=float((f_s - f_one).abs().max()),
                        one_vs_one_max_abs_dpos=float(
                            (f_one2 - f_one).abs().max()),
                        wall_s=wall)
        check(n_ids == 0, f'shard {key}: {n_ids} first-iteration face ids '
              f'differ from the one-process block')
        check(err1 < 5e-3, f'shard {key}: first-iteration positions differ '
              f'by {err1} >= 5e-3')
        check(int(d_s.n_done) == int(d_one.n_done),
              f'shard {key}: {int(d_s.n_done)} iterations done, one '
              f'process {int(d_one.n_done)}')
        check(d_r < 0.2, f'shard {key}: |dR| = {d_r} nm after {rf} '
              f'iterations')
        check(bits_differ(f_one2, f_one) == 0, f'shard {key}: two '
              f'one-process blocks differ')
        if mesh.world_size == 1:
            p, s, w, m = shard_points(mesh, 0, b.pts, b.sigma_inv,
                                      b.weights)
            f_pad, _ = cg_block(ma.positions, ma.faces, ma.f_mask,
                                ma.v_mask, ma.nbr_v, p, s, w, m, 2.0,
                                num_iters=rf, corr_method='windowed',
                                face_nbrs=ma.face_nbrs, tables=b.tables,
                                face_hcgc=hcgc)
            n_bits = bits_differ(f_s, f_pad)
            out[key].update(padded_rows=int(p.shape[0]),
                            padded_max_abs_dpos=float(
                                (f_s - f_pad).abs().max()),
                            padded_bits_differ=n_bits)
            check(n_bits == 0, f'shard {key}: {n_bits} positions differ '
                  f'from the one-process block on the padded cloud')
    return out


def check_shard_fit(fit, one, launches, iters=20):
    check_fit(fit, mean_tol=SIGMA, tag='shard')
    d_r = abs(fit['R_mean'] - one['R_mean'])
    check(d_r < 0.2, f'shard: |dR| to the one-process fit = {d_r} nm')
    check(fit['method'] == one['method'],
          f"shard: method {fit['method']}, one process {one['method']}")
    check(fit['in_step_checks'] == fit['blocks'],
          f"shard: {fit['in_step_checks']} in-step checks for "
          f"{fit['blocks']} blocks")
    check(fit['diag_rows'] == N_POINTS,
          f"shard: {fit['diag_rows']} diagnostic rows, not {N_POINTS}")
    for key in ('K1', 'K2'):
        check(launches[key] == iters,
              f'shard: {key} launched {launches[key]} times on rank 0, '
              f'not {iters}')
    for key in WINDOWED_PATH:
        check(launches[key] > 0,
              f'{key} was not launched on rank 0 of the shard fit')
    return d_r


def check_corr_fit(fit, method):
    check(fit['method'] == method,
          f"corr: the {method} fit ran {fit['method']}")
    check(abs(fit['R_mean'] - RADIUS) < SIGMA,
          f"{method} fit |R - {RADIUS}| = {abs(fit['R_mean'] - RADIUS)} "
          f">= {SIGMA}")
    check(fit['euler'] == 2, f"{method} fit euler {fit['euler']}")
    check(fit['manifold'], f'{method} fit mesh not manifold')


def jax_suite_corr_case(device):
    """tests/test_solver.py:38-73's fixture: icosphere(4) at R = 50, 5000
    points within a few nm, 100 far points, cell 2 x the mean edge."""
    import torch
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.ops import meshdata
    rng = np.random.default_rng(3)
    v, f = icosphere(4, radius=50.0)
    mesh = TriangleMesh(v, f)
    ma = meshdata.from_mesh(mesh, quantum=256, device=device)
    d = rng.normal(size=(5000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50.0 + rng.normal(scale=3.0, size=d.shape)).astype(np.float32)
    far = (d[:100] * 200.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (t(pts), t(far), ma.positions[ma.faces.long()].mean(1), ma.f_mask,
            2.0 * mesh._mean_edge_length)


def phase_corr(device='cuda', n_run=65_536, n_cpu=16_384, margin=40.0):
    """The hash-grid and blocked searches on the card.  On the JAX
    suite's fixture, the suite's bounds against the exact search (ids
    agree > 0.98, |dd| < cell, far points within 5 nm) for both.  On the
    kernels phase's mesh and a contiguous run of ``n_run`` points of the
    sorted cloud, the agreement with the exact search (over the faces
    within ``margin`` of the run) is read, not gated (both packages'
    searches give these ids), and on the run's first ``n_cpu`` points
    the card's ids equal the port's CPU ids.  It also counts the grid's
    hash buckets: the occupied cells, the buckets they fall into, and
    the faces in buckets past the 32-face cap.  Runs on the CPU as well
    (``device='cpu'``, minutes)."""
    import torch
    from ch_shrinkwrap_torch.ops import correspondence as corr
    from ch_shrinkwrap_torch.ops.ordering import fit_point_order
    dev = torch.device(device)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        return out, time.time() - t0

    out = {}
    pts, far, centers, fm, cell = jax_suite_corr_case(dev)
    order = torch.from_numpy(fit_point_order(pts.cpu().numpy())).to(dev)
    db, ib = corr.nearest_face_bruteforce(pts, centers, fm)
    dg, ig = corr.nearest_face_grid(pts, centers, fm, cell)
    dk, ik = corr.nearest_face_blocked(pts[order], centers, fm)
    dbf, _ = corr.nearest_face_bruteforce(far, centers, fm)
    dgf, _ = corr.nearest_face_grid(far, centers, fm, cell)
    suite = dict(cell=cell,
                 grid_agree=float((ig == ib).float().mean()),
                 grid_max_dd=float((dg - db).abs().max()),
                 grid_far_lo=float((dgf - dbf).min()),
                 grid_far_hi=float((dgf - dbf).max()),
                 blocked_agree=float((ik == ib[order]).float().mean()),
                 blocked_max_dd=float((dk - db[order]).abs().max()))
    out['suite'] = suite
    check(suite['grid_agree'] > 0.98,
          f"corr: grid agrees on {suite['grid_agree']} <= 0.98")
    check(suite['grid_max_dd'] < cell,
          f"corr: grid |dd| {suite['grid_max_dd']} >= cell {cell}")
    check(suite['grid_far_lo'] >= -1e-3 and suite['grid_far_hi'] <= 5.0,
          f"corr: far points off by {suite['grid_far_lo']} .. "
          f"{suite['grid_far_hi']}")
    check(suite['blocked_agree'] > 0.98,
          f"corr: blocked agrees on {suite['blocked_agree']} <= 0.98")
    check(suite['blocked_max_dd'] < cell,
          f"corr: blocked |dd| {suite['blocked_max_dd']} >= cell {cell}")

    pts_np, _ = sphere_cloud()
    pts_np = pts_np[fit_point_order(pts_np)]
    k0 = (len(pts_np) - n_run) // 2
    run = torch.from_numpy(np.ascontiguousarray(pts_np[k0:k0 + n_run]))
    mesh, ma = _kernel_mesh(dev)
    centers = ma.positions[ma.faces.long()].mean(1)
    cell = 2.0 * mesh._mean_edge_length
    p = run.to(dev)
    lo, hi = p.min(0).values - margin, p.max(0).values + margin
    near = torch.nonzero(((centers >= lo) & (centers <= hi)).all(1)
                         & ma.f_mask)[:, 0]
    (db, ib), t_b = timed(lambda: corr.nearest_face_bruteforce(
        p, centers[near], ma.f_mask[near], point_block=4096,
        face_chunk=16384))
    ib = near[ib.long()]
    check(float(db.max()) < margin, f'corr: a nearest face lies beyond '
          f'the {margin} nm margin ({float(db.max())})')
    (dg, ig), t_g = timed(lambda: corr.nearest_face_grid(
        p, centers, ma.f_mask, cell))
    (dk, ik), t_k = timed(lambda: corr.nearest_face_blocked(
        p, centers, ma.f_mask))
    c_cpu, fm_cpu = centers.cpu(), ma.f_mask.cpu()
    differ = {}
    for name, fn, args in (('grid', corr.nearest_face_grid, (cell,)),
                           ('blocked', corr.nearest_face_blocked, ())):
        _, i_card = fn(p[:n_cpu], centers, ma.f_mask, *args)
        _, i_cpu = fn(run[:n_cpu], c_cpu, fm_cpu, *args)
        differ[name] = int((i_card.cpu() != i_cpu).sum())
    n_g, n_k = differ['grid'], differ['blocked']
    inv_h = torch.tensor(1.0) / torch.tensor(float(cell))
    cells = torch.floor(c_cpu[fm_cpu] * inv_h).int()
    _, per_bucket = torch.unique(corr._cell_hash(cells, 1 << 18),
                                 return_counts=True)
    out['fit_scale'] = dict(
        n_points=n_run, faces_searched=int(near.numel()), cell=cell,
        faces=int(fm_cpu.sum()),
        cells=int(torch.unique(cells, dim=0).shape[0]),
        buckets=int(per_bucket.numel()),
        faces_past_cap=int(per_bucket[per_bucket > 32].sum()),
        grid_agree=float((ig == ib).float().mean()),
        grid_max_dd=float((dg - db).abs().max()),
        blocked_agree=float((ik == ib).float().mean()),
        blocked_max_dd=float((dk - db).abs().max()),
        grid_card_vs_cpu_differ=n_g, blocked_card_vs_cpu_differ=n_k,
        brute_s=t_b, grid_s=t_g, blocked_s=t_k)
    check(n_g == 0, f'corr: {n_g} grid ids differ between card and CPU')
    check(n_k == 0, f'corr: {n_k} blocked ids differ between card and CPU')
    return out


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
        t0 = time.time()
        host = phase_host_engine()
        phase_line('build.host_engine', time.time() - t0, **host)
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
        for key in WINDOWED_PATH:
            check(launches[key] > 0,
                  f'{key} was not launched during the fit')
        check(launches['field'] == 1, f"the seed's field launched "
              f"{launches['field']} times, not once")
        check(launches['brute'] == 0, f"the windowed fit launched the "
              f"brute-force search {launches['brute']} times")
        # 20 iterations from the offset-25 seed stop short of the cloud
        # (the JAX package too, PERF.md section 6): the radius bound is
        # one localization sigma; the 39-iteration fit below is held to
        # 1.5 nm
        check_fit(fit, mean_tol=SIGMA)
        # the same fit again: every sum on the card has one order, so the
        # final mesh is the same bit for bit
        t0 = time.time()
        again = phase_fit()
        again.pop('trace')
        phase_line('fit.again', time.time() - t0,
                   bit_identical=same_bits(fit, again),
                   **{k: again[k] for k in ('fit_s', 'V', 'R_mean',
                                            'sha_vertices', 'sha_faces')})
        check(same_bits(fit, again), 'fit: two runs of the same fit give '
              'different meshes')
        t0 = time.time()
        with plain_versions():
            ref = phase_fit()
        ref.pop('trace')
        same = check_same_fit(fit, ref)
        phase_line('fit.plain', time.time() - t0, **same, **ref)
        # every kernel adds in its plain version's order: the same mesh
        # bit for bit
        check(same['bit_identical'], 'fit vs plain: the meshes differ in '
              'bits')
        t0 = time.time()
        conv = phase_fit(iters=39)
        conv.pop('trace')
        phase_line('fit.39it', time.time() - t0, **conv)
        check_fit(conv, tag='39-iteration fit')
    with Watchdog('shard', DEADLINES['shard']):
        t0 = time.time()
        for key, rec in phase_shard_block().items():
            phase_line(f'shard.block.{key}', 0.0, **rec)
        t1 = time.time()
        for w in wrappers.values():
            w.launches = 0
        sh = phase_fit(devices=shard_devices())
        launches_sh = {k: w.launches for k, w in wrappers.items()}
        trace = sh.pop('trace')
        for rec in trace:
            print('  trace:', *rec, flush=True)
        # a reading, not a claim: two ranks on one card share it
        phase_line('shard.fit', time.time() - t1, launches=launches_sh,
                   rank0_fit_s=sh['fit_s'], one_process_fit_s=fit['fit_s'],
                   dR_one_process=abs(sh['R_mean'] - fit['R_mean']), **sh)
        check_shard_fit(sh, fit, launches_sh)
        phase_line('shard', time.time() - t0)
    with Watchdog('corr', DEADLINES['corr']):
        t0 = time.time()
        cr = phase_corr()
        phase_line('corr.suite', 0.0, **cr['suite'])
        phase_line('corr.fit_scale', 0.0, **cr['fit_scale'])
        for method in ('grid', 'blocked'):
            t1 = time.time()
            cf = phase_fit(corr_method=method)
            cf.pop('trace')
            phase_line(f'corr.fit.{method}', time.time() - t1, **cf)
            check_corr_fit(cf, method)
        phase_line('corr', time.time() - t0)
    with Watchdog('fit99', DEADLINES['fit99']):
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        fit99 = phase_fit99()
        launches99 = {k: w.launches for k, w in wrappers.items()}
        trace = fit99.pop('trace')
        wall = fit99.pop('wall')
        for rec in trace:
            print('  trace:', *rec, flush=True)
        phase_line('fit99', time.time() - t0, launches=launches99, **fit99)
        phase_line('fit99.wall', 0.0, **wall)
        check_fit99(fit99, launches99)
        t0 = time.time()
        again = phase_fit99()
        phase_line('fit99.again', time.time() - t0,
                   bit_identical=same_bits(fit99, again),
                   **{k: again[k] for k in ('fit_s', 'V', 'R_mean',
                                            'sha_vertices', 'sha_faces')})
        check(same_bits(fit99, again), 'fit99: two runs of the north star '
              'give different meshes')
    with Watchdog('punch', DEADLINES['punch']):
        t0 = time.time()
        card = phase_punch()
        cpu = phase_punch('cpu')
        phase_line('fit.punch', time.time() - t0, **{
            **{k: v for k, v in card.items() if k != 'trace'},
            'cpu_n_punched': cpu['n_punched'], 'cpu_euler': cpu['euler'],
            'cpu_fit_s': cpu['fit_s'], 'trace': card['trace']})
        check_punch(card, cpu)
    with Watchdog('image', DEADLINES['image']):
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        img = phase_image()
        launches_img = {k: w.launches for k, w in wrappers.items()}
        trace = img.pop('trace')
        wall = img.pop('wall')
        for rec in trace:
            print('  trace:', *rec, flush=True)
        phase_line('image', time.time() - t0, launches=launches_img, **img)
        phase_line('image.wall', 0.0, **wall)
        check_image(img, launches_img)
        t0 = time.time()
        short = phase_image(iters=10)
        with plain_versions():
            short_ref = phase_image(iters=10)
        d_r = abs(short['R_mean'] - short_ref['R_mean'])
        phase_line('image.plain', time.time() - t0, dR=d_r,
                   R_kernels=short['R_mean'], R_plain=short_ref['R_mean'],
                   V_kernels=short['V'], V_plain=short_ref['V'],
                   bit_identical=same_bits(short, short_ref),
                   fit_s_kernels=short['fit_s'],
                   fit_s_plain=short_ref['fit_s'])
        check(d_r < 0.2, f'image at 10 iterations vs plain: |dR| = {d_r}')
    with Watchdog('sweep', DEADLINES['sweep']):
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        sw = phase_sweep()
        launches_sw = {k: w.launches for k, w in wrappers.items()}
        row = sw['rows'][0] if sw['rows'] else {}
        phase_line('sweep', time.time() - t0, launches=launches_sw,
                   first_s=sw['first_s'], restart_s=sw['restart_s'],
                   restart_rows=sw['restart_rows'], plain_s=sw['plain_s'],
                   sha_stl=sw['sha_stl'], plain_sha_stl=sw['plain_sha_stl'],
                   **{
                       k: row.get(k) for k in (
                           'sdf_rms', 'berger_mean_distance', 'duration',
                           'ntriangles', 'euler', 'components',
                           'manifold', 'topology_correct', 'mse_rms',
                           'sdf_hausdorff', 'berger_hausdorff')})
        check_sweep(sw)
        check(launches_sw['segsum'] > 0,
              'segsum was not launched during the sweep')
        check(launches_sw['brute'] > 0,
              'the brute-force search was not launched during the sweep')
    with Watchdog('grids', DEADLINES['grids']):
        t0 = time.time()
        grids = phase_grids(GRID_ENTRIES + (REPEAT_ENTRY, REPEAT_ENTRY))
        for i, r in enumerate(grids):
            row = r['row'] or {}
            name = r['config'][:-5] + ('.recipe' if r['via_recipe'] else '')
            if i >= len(GRID_ENTRIES):
                name += f'.repeat{i - len(GRID_ENTRIES)}'
            phase_line(f'grids.{name}', r['wall_s'] or 0.0,
                       entry=r['entry'], status=r['status'],
                       launches=r['launches'], sdf_ref=r['sdf_ref'],
                       sdf_tol=r['sdf_tol'], **{
                           k: row.get(k) for k in (
                               'sdf_rms', 'duration', 'ntriangles',
                               'euler', 'components', 'manifold',
                               'topology_correct')})
        phase_line('grids', time.time() - t0)
        check_grids(grids[:len(GRID_ENTRIES)])
        check_repeat(grids[len(GRID_ENTRIES):])

    print(f'total {time.time() - t_all:.1f}s', flush=True)
    table = []
    for key in ('K1', 'K2', 'segsum', 'K3', 'K3f', 'field', 'brute'):
        rec = dict(recs[key])
        rec.pop('checks')
        # launches: the count of the kernel's path (launches_path): the
        # north-star fit's (fit99), or for segment_sum_ordered and the
        # brute-force search, which have no work there (WINDOWED_PATH),
        # the sweep's; launches_fit20, launches_image, launches_sweep: the
        # 20-iteration fit's, the image recipe's and the sweep's
        path = 'sweep' if key in ('segsum', 'brute') else 'fit99'
        rec['launches'] = (launches99 if path == 'fit99'
                           else launches_sw)[key]
        rec['launches_path'] = path
        rec['launches_fit20'] = launches[key]
        rec['launches_image'] = launches_img[key]
        rec['launches_sweep'] = launches_sw[key]
        table.append({k: rec[k] for k in (
            'name', 'route', 'source', 'replaces', 'launches',
            'launches_path', 'launches_fit20', 'launches_image',
            'launches_sweep', 'max_abs_err', 'ms', 'call_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms')})
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
