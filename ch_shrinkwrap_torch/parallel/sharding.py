"""Multi-device fits over ``torch.distributed``: the localization cloud
sharded over ranks.

Counterpart of the JAX package's ``parallel/sharding.py``.  The points,
their inverse errors, the residual weights and the point mask are split
over the ranks in contiguous slices of whole 256-point blocks of the
``fit_point_order``-sorted cloud; the vertex and face state is
replicated on every rank.  Inside ``cg_block(spmd_mesh=...)`` each rank
finds the nearest faces of its own slice against its full copy of the
face table (exact, no collective), accumulates A^T of its points onto
the faces (K2 or the ordered segment sum) and joins one all-reduce of the face
accumulators a CG iteration, plus one of the small reductions (the
point-side normal equations and the residual norm).  The vertex-side
work (K3, K3f, the curvature prior, the subspace solve) runs on every
rank on the same inputs.

Ranks are processes: ``run_ranks`` runs rank 0 in the calling process
and spawns ranks 1..n-1 (the ``spawn`` start method: CUDA cannot fork),
joined through a ``FileStore`` in a fresh temporary directory.  A fit
keeps its ranks in step: after each CG block every rank takes rank 0's
vertex positions (the host passes between blocks are deterministic
only on identical inputs, and an all-reduce of more than two ranks may
add in another order than a rank's own sums), and after each boundary one all-reduce compares
(V, F) and checksums of the faces and vertices, raising on a mismatch.
Every group has a timeout, so a rank that strays fails instead of
hanging.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

# the windowed search works on 256-point blocks: every rank holds
# whole blocks
BLOCK = 256
DEFAULT_TIMEOUT_S = 300.0
JOIN_DEADLINE_S = 60.0


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The ranks of a sharded fit: one torch device per rank and the
    process-group backend ('nccl' when every rank has a card of its
    own, 'gloo' when ranks share a card or run on the CPU)."""
    world_size: int
    devices: Tuple[torch.device, ...]
    backend: str
    timeout_s: float = DEFAULT_TIMEOUT_S


def _n_cpus():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _device(d):
    d = torch.device(d)
    if d.type == 'cuda' and d.index is None:
        d = torch.device('cuda', 0)
    return d


def make_device_mesh(n_devices=None, devices=None,
                     timeout_s=DEFAULT_TIMEOUT_S):
    """A ``DeviceMesh`` of ``n_devices`` ranks.

    ``devices`` defaults to every CUDA card, one rank each.  An explicit
    list such as ``['cuda:0', 'cuda:0']`` puts two ranks on one card,
    and ``['cpu', 'cpu']`` runs two ranks on the CPU; this is opt-in,
    never a fallback.  Raises when fewer than ``n_devices`` devices
    exist instead of silently truncating, when a CUDA index is not a
    card of this machine, and when more CPU ranks are asked for than
    the process has cores.  Prints the ranks and the backend."""
    if devices is None:
        n_cards = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        devices = [torch.device('cuda', i) for i in range(n_cards)]
        what = f'{n_cards} CUDA card(s) exist'
    else:
        devices = [_device(d) for d in devices]
        what = f'{len(devices)} device(s) were given'
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f'requested a {n_devices}-device mesh but only {what}; '
                "pass devices=['cuda:0', 'cuda:0'] to share one card or "
                "devices=['cpu'] * n for CPU ranks")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError(f'no device for a device mesh: {what}')
    types = {d.type for d in devices}
    if len(types) != 1 or not types <= {'cuda', 'cpu'}:
        raise ValueError(f'a device mesh needs all-CUDA or all-CPU '
                         f'devices, got {devices}')
    if 'cuda' in types:
        n_cards = torch.cuda.device_count() \
            if torch.cuda.is_available() else 0
        bad = [d for d in devices if d.index >= n_cards]
        if bad:
            raise ValueError(f'{bad} are not CUDA cards of this machine '
                             f'({n_cards} exist)')
    elif len(devices) > _n_cpus():
        raise ValueError(f'requested {len(devices)} CPU ranks but the '
                         f'process has {_n_cpus()} cores')
    # NCCL refuses two ranks on one card
    backend = 'nccl' if ('cuda' in types
                         and len(set(devices)) == len(devices)) else 'gloo'
    mesh = DeviceMesh(len(devices), tuple(devices), backend,
                      float(timeout_s))
    print(f"device mesh: {mesh.world_size} rank(s) on "
          f"{', '.join(str(d) for d in devices)}, backend {backend}",
          flush=True)
    return mesh


def mesh_for(device_mesh, device):
    """``MembraneMesh.device_mesh`` as a ``DeviceMesh``: an int is that
    many cards, or that many CPU ranks for a model on the CPU."""
    if device_mesh is None or isinstance(device_mesh, DeviceMesh):
        return device_mesh
    n = int(device_mesh)
    if torch.device(device).type == 'cpu':
        return make_device_mesh(n, devices=['cpu'] * n)
    return make_device_mesh(n)


def in_group(mesh):
    """True inside a process group of ``mesh``'s world size."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() == mesh.world_size)


def spmd_rank(mesh):
    """This process's rank for ``cg_block(spmd_mesh=mesh)``; raises
    unless ``mesh`` is a ``DeviceMesh`` inside an initialised process
    group of its world size."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f'spmd_mesh must be a parallel.sharding.DeviceMesh'
                        f', got {type(mesh).__name__}')
    if not in_group(mesh):
        raise ValueError('spmd_mesh needs an initialised process group of '
                         f'{mesh.world_size} rank(s); run the block through '
                         'sharded_cg_block or run_ranks')
    return dist.get_rank()


# ----------------------------------------------------------------------
# the cloud


def _np(a, dtype):
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def pad_to_multiple(arr, multiple, axis=0, fill=0):
    """Pad ``arr`` along ``axis`` to a multiple of ``multiple`` with
    ``fill``, or with copies of the last entry for ``fill='edge'``.
    Returns (padded, original length)."""
    arr = np.asarray(arr)
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    if fill == 'edge':
        return np.pad(arr, pad, mode='edge'), n
    return np.pad(arr, pad, constant_values=fill), n


def shard_points(mesh, rank, points, sigma_inv, weights, point_mask=None):
    """Rank ``rank``'s slice of the cloud as tensors on its device:
    (points, sigma_inv, weights, point_mask), the cloud padded to a
    multiple of ``256 * world_size``.

    The pad repeats the last point (and its inverse error), with zero
    weights and a false mask, so pad rows drop out of every sum.  The
    JAX package pads with zeros, which pulls the last partial block's
    median centroid toward the origin; with the last point repeated,
    as ``nearest_face_windowed`` pads in one process, every real block
    is the block the one-process search sees."""
    mult = BLOCK * mesh.world_size
    pts, n = pad_to_multiple(_np(points, np.float32), mult, fill='edge')
    sig, _ = pad_to_multiple(_np(sigma_inv, np.float32), mult, fill='edge')
    w, _ = pad_to_multiple(_np(weights, np.float32), mult)
    mask = np.zeros(pts.shape[0], bool)
    mask[:n] = True if point_mask is None else _np(point_mask, bool)
    n_loc = pts.shape[0] // mesh.world_size
    sl = slice(rank * n_loc, (rank + 1) * n_loc)
    dev = mesh.devices[rank]
    return tuple(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                 for a in (pts, sig, w, mask))


def gather_points(local, n_total=None):
    """The full-length array of per-point rows whose rank-local slices
    are ``local``, on every rank: one all-reduce of zero-filled
    full-length buffers (gloo cannot all-gather CUDA tensors)."""
    rank, ws = dist.get_rank(), dist.get_world_size()
    n_loc = local.shape[0]
    full = torch.zeros((n_loc * ws,) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    full[rank * n_loc:(rank + 1) * n_loc] = local
    dist.all_reduce(full)
    return full if n_total is None else full[:n_total]


def gather_diagnostics(diag, n_total=None):
    """``SolverDiagnostics`` with the per-point rows (``res``, ``d``,
    ``fi``) gathered to full length, in the one-process order."""
    rows = gather_points(torch.cat([diag.res, diag.d[:, None]], 1),
                         n_total)
    fi = None if diag.fi is None else gather_points(diag.fi, n_total)
    return diag._replace(res=rows[:, :3].contiguous(),
                         d=rows[:, 3].contiguous(), fi=fi)


# ----------------------------------------------------------------------
# keeping the ranks in step


def broadcast_from_rank0(*tensors):
    """Every rank takes rank 0's values of ``tensors`` (in place)."""
    for t in tensors:
        if t is not None:
            dist.broadcast(t, src=0)


def _comm_device(mesh):
    return mesh.devices[dist.get_rank()] if mesh.backend == 'nccl' \
        else torch.device('cpu')


def check_in_step(mesh, vertices, faces, where=''):
    """Raise ``RuntimeError`` unless every rank holds the same (V, F),
    face table and vertex bits: one all-reduce (MAX of the values and
    of their negatives)."""
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int32).reshape(-1).astype(np.int64)
    cs_f = int((f * (np.arange(f.size, dtype=np.int64) % 1009 + 1)).sum())
    cs_v = int(v.reshape(-1).view(np.int32).astype(np.int64).sum())
    loc = torch.tensor([v.shape[0], faces.shape[0], cs_f, cs_v],
                       dtype=torch.int64)
    t = torch.cat([loc, -loc]).to(_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    t = t.cpu()
    hi, lo = t[:4].tolist(), (-t[4:]).tolist()
    if hi != lo:
        raise RuntimeError(
            f'ranks out of step{where}: (V, F, face checksum, vertex '
            f'checksum) range from {lo} to {hi} across ranks; rank '
            f'{dist.get_rank()} has {loc.tolist()}')


# ----------------------------------------------------------------------
# ranks as processes


def _init_group(mesh, rank, store_dir):
    dev = mesh.devices[rank]
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    if mesh.backend == 'nccl':
        # a timed-out collective raises instead of aborting the process
        os.environ.setdefault('TORCH_NCCL_BLOCKING_WAIT', '1')
    dist.init_process_group(
        mesh.backend, init_method='file://' + os.path.join(store_dir,
                                                           'store'),
        world_size=mesh.world_size, rank=rank,
        timeout=datetime.timedelta(seconds=mesh.timeout_s))


def _rank_main(rank, mesh, store_dir, fn, args, n_threads):
    """A spawned rank: join the group, run ``fn(*args)``, leave."""
    torch.set_num_threads(n_threads)
    try:
        _init_group(mesh, rank, store_dir)
        try:
            fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(store_dir, f'rank{rank}.err'), 'w') as fh:
            fh.write(traceback.format_exc())
        sys.exit(1)


def run_ranks(mesh, rank0_fn, worker_fn, worker_args=()):
    """Run ``rank0_fn()`` as rank 0 in this process and
    ``worker_fn(*worker_args)`` as ranks 1..n-1 in spawned processes,
    all in one process group of ``mesh``; returns rank 0's result.

    ``worker_fn`` must be importable in a fresh interpreter (a
    module-level function of the port).  The group is destroyed on every
    exit path; rank 0 joins the workers for at most ``JOIN_DEADLINE_S``
    seconds and then kills them.  A failure on any rank raises here, with the
    workers' tracebacks."""
    if dist.is_initialized():
        raise RuntimeError('a process group is already initialised in '
                           'this process')
    store_dir = tempfile.mkdtemp(prefix='csw_ranks_')
    ctx = torch.multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, mesh, store_dir, worker_fn,
                               tuple(worker_args), torch.get_num_threads()))
             for r in range(1, mesh.world_size)]
    err = out = None
    try:
        for p in procs:
            p.start()
        _init_group(mesh, 0, store_dir)
        try:
            out = rank0_fn()
        finally:
            dist.destroy_process_group()
    except BaseException as e:
        err = e
    finally:
        deadline = time.time() + JOIN_DEADLINE_S
        for p in procs:
            p.join(max(0.0, deadline - time.time()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        failed = []
        for r, p in enumerate(procs, 1):
            path = os.path.join(store_dir, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as fh:
                    failed.append(f'rank {r}:\n{fh.read()}')
            elif p.exitcode != 0:
                failed.append(f'rank {r}: exit code {p.exitcode}')
        shutil.rmtree(store_dir, ignore_errors=True)
    if err is not None:
        if failed and not isinstance(err, RuntimeError):
            raise RuntimeError('\n'.join(failed)) from err
        raise err
    if failed:
        raise RuntimeError('\n'.join(failed))
    return out


# ----------------------------------------------------------------------
# sharded CG block and sharded fit


def _move(obj, device):
    """``obj`` with every tensor inside (tuples, named tuples, lists,
    dicts) moved to ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, '_fields'):
        return type(obj)(*(_move(x, device) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_move(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    return obj


def _block_rank(mesh, mesh_arrays, cloud, lam0, shrink_lam, cg_kwargs):
    """One rank of ``sharded_cg_block``: its slice of the cloud through
    ``cg_block(spmd_mesh=mesh)``; returns the positions and the
    diagnostics with the per-point rows gathered."""
    from ..solver.shrinkwrap import cg_block
    rank = dist.get_rank()
    dev = mesh.devices[rank]
    ma = _move(mesh_arrays, dev)
    kw = _move(cg_kwargs, dev)
    if kw.get('tables') is True:
        from ..ops.meshdata import gather_tables
        kw['tables'] = gather_tables(ma)
    pts, sig, w, pm = shard_points(mesh, rank, *cloud)
    f, diag = cg_block(ma.positions, ma.faces, ma.f_mask, ma.v_mask,
                       ma.nbr_v, pts, sig, w, pm, lam0, shrink_lam,
                       spmd_mesh=mesh, **kw)
    return f, gather_diagnostics(diag)


def sharded_cg_block(mesh, mesh_arrays, points, sigma_inv, weights,
                     point_mask=None, lam0=1.0, shrink_lam=0.0,
                     num_iters=5, use_shrink=False, face_chunk=2048,
                     corr_method='brute', **cg_kwargs):
    """Run one CG block with the cloud sharded over ``mesh``'s ranks.

    ``points``, ``sigma_inv``, ``weights`` and ``point_mask`` are the
    whole cloud (``fit_point_order``-sorted for the windowed and
    blocked searches); each rank takes its ``shard_points`` slice.
    ``mesh_arrays`` is replicated.  Further ``cg_block`` keywords pass
    through (``face_nbrs``, ``face_hcgc``, ...); ``tables=True`` builds
    the K3 gather tables on every rank.  Returns rank 0's
    (positions, SolverDiagnostics) on ``mesh.devices[0]``, the
    per-point rows at the padded length ``256 * world_size``-rounded."""
    cloud = (points, sigma_inv, weights, point_mask)
    cloud = tuple(None if a is None else
                  (a.detach().cpu() if torch.is_tensor(a) else np.asarray(a))
                  for a in cloud)
    kw = dict(cg_kwargs, num_iters=num_iters, use_shrink=use_shrink,
              face_chunk=face_chunk, corr_method=corr_method)
    args = (mesh, _move(mesh_arrays, 'cpu'), cloud, float(lam0),
            float(shrink_lam), _move(kw, 'cpu'))
    return run_ranks(mesh, lambda: _block_rank(*args), _block_rank, args)


# model attributes that hold device state or the rank layout; a rank
# rebuilds them
_RUNTIME_ATTRS = ('trace', '_last_diag', '_curv_state', 'device')


def _holds_tensor(x):
    if torch.is_tensor(x):
        return True
    if isinstance(x, (tuple, list)):
        return any(_holds_tensor(y) for y in x)
    if isinstance(x, dict):
        return any(_holds_tensor(y) for y in x.values())
    return False


def host_state(model):
    """The picklable host state of a model: its attributes without the
    device caches (rebuilt on demand)."""
    return {k: v for k, v in model.__dict__.items()
            if k not in _RUNTIME_ATTRS and not _holds_tensor(v)}


def fit_rank(cls, state, points, sigma, kwargs):
    """A spawned rank of a sharded fit: rebuild the model from rank 0's
    host state on this rank's device and run the same fit."""
    model = cls.__new__(cls)
    model.__dict__.update(state)
    model.trace = None
    model._last_diag = None
    model._curv_state = None
    model.device = model.device_mesh.devices[dist.get_rank()]
    model.opt_conjugate_gradient(points, sigma, **kwargs)


def sharded_fit(mesh_model, points, sigma, n_devices=None, devices=None,
                **kwargs):
    """A full ``shrink_wrap`` fit with the cloud sharded over
    ``n_devices`` ranks (cards, or CPU ranks on a CPU model; every card
    when neither count nor ``devices`` is given): every CG block runs on
    each rank's slice with all-reduced face accumulators, and every rank
    runs the host passes between blocks.  ``mesh_model`` (rank 0) ends
    fitted in place."""
    if devices is None and n_devices is not None:
        mesh_model.device_mesh = int(n_devices)
    else:
        mesh_model.device_mesh = make_device_mesh(n_devices, devices)
    return mesh_model.shrink_wrap(points, sigma, **kwargs)
