"""What decides ``correct``: the timed path's own state against the plain
reference, after the window has closed.

The fit is followed block by block from the program's state: for each
CG block the seed picks, the reference (``reference.cg_block``, float64)
runs the block again from the state the program started it from, with
the benchmark's own copy of the cloud put in the program's point order,
and the settings worked out from the configuration and the workload.
The stages this skips are checked by themselves:

* ``block_gap``: RMS over the vertices of |program - reference| after
  the block, over the RMS of the reference's own step; the largest over
  the sampled blocks.
* ``surgery_gap`` (nm): the 90th percentile, over the vertices (a
  seed-drawn sample of them), of the distance of the surface the host
  surgery and the rebuild hand to a sampled block from the surface the
  block before it left.  The remesh moves a vertex off that surface
  only through flipped edges it then splits or collapses; the neck pass
  caps what it cuts out, a few hundredths of the vertices, which the
  percentile passes over.
* ``defects``: faults of the surfaces handed on (open, repeated or
  out-of-range edges and indices, masks that are not prefixes), rows of
  the program's cloud that are not the benchmark's, a point mask that
  leaves a point out, and a block whose iteration count is not the
  schedule's; the final surface's faults too.

* ``edge_gap``: how far the mean edge of each surface the remesh hands
  to a sampled block, and of the final surface, lies from the length
  the fit's schedule sets for it, as a share of that length.  The
  schedule runs linearly from the mean edge of the fit's first surface
  to the configuration's minimum edge (or sigma / 2.5 where that is
  negative), and is worked out here from the configuration and the
  workload.
* ``neck_miss``: the share of the vertices that the plain Gaussian
  curvature (``reference.mesh_checks.gaussian_k``) puts clear past a
  neck threshold on the surface the neck pass got, at the boundary
  before each sampled block, that are still vertices of the surface it
  left; the largest over those boundaries.  Where more than a quarter
  of the vertices pass a threshold the pass removes nothing, by its
  definition, and the boundary is passed over.
* ``shape_gap`` (nm): the final surface's used vertices against the
  true shape the configuration's cloud names (``cloud.shape``), reduced
  as that shape's module under ``reference/shapes/`` states (for the
  sphere, the RMS of the vertices' distance from it).

With ``control`` the reference in bfloat16 takes the program's place in
``block_gap``, and the surgery's surface rounded to bfloat16 in
``surgery_gap``: both have to come out over their limits.
"""

import math

import numpy as np
import torch

from .reference import cg_block as ref
from .reference import mesh_checks

NUMBERS = ('block_gap', 'surgery_gap', 'edge_gap', 'neck_miss',
           'shape_gap', 'defects')
SURFACE_SAMPLE = 20000
# a vertex counts as flagged when its curvature clears the threshold by
# this share of it: float32 and float64 curvatures part only at ties
NECK_MARGIN = 0.01


def schedule(workload, max_iter=None):
    """[(start iteration, iterations)] of the fit's CG blocks, from the
    workload's cadences (a block runs to the next boundary of either)."""
    n = max_iter or workload['iterations']
    rf, pf = workload['remesh_frequency'], workload['punch_frequency']
    r = rf != 0 and rf <= n
    d = pf != 0 and pf <= n
    out, j = [], 0
    while j < n:
        k = n - j
        if r:
            k = min(k, rf - j % rf)
        if d:
            k = min(k, pf - j % pf)
        out.append((j, k))
        j += k
    return out


def edge_target(config, workload, l0, sigma_min, j):
    """The length the fit's schedule sets for the remesh at boundary
    ``j``, from the first surface's mean edge ``l0``."""
    n = workload['iterations']
    rf, pf = workload['remesh_frequency'], workload['punch_frequency']
    step = math.gcd(rf, pf) if (pf != 0 and pf <= n) else rf
    lf = config['minimum_edge_length']
    if lf < 0:
        lf = float(np.clip(sigma_min / 2.5, 1.0, 50.0))
    m = (lf - l0) / (step * math.ceil(n / step))
    return float(np.clip(l0 + m * (j + 1), min(l0, lf), max(l0, lf)))


def remesh_boundaries(workload):
    n, rf = workload['iterations'], workload['remesh_frequency']
    if rf == 0 or rf > n:
        return []
    return list(range(rf, n + 1, rf))


def static_iters(workload):
    n = workload['iterations']
    rf, pf = workload['remesh_frequency'], workload['punch_frequency']
    if rf != 0 and rf <= n:
        n = min(n, rf)
    if pf != 0 and pf <= workload['iterations']:
        n = min(n, pf)
    return n


def sample_blocks(workload, seed, count=3):
    """Indices of the blocks the check follows: blocks that start at a
    remesh boundary (any block but the first where none remeshes)."""
    blocks = schedule(workload)
    rf = workload['remesh_frequency']
    cand = [i for i, (j, _) in enumerate(blocks)
            if i > 0 and (rf == 0 or j % rf == 0)]
    if not cand:
        cand = list(range(len(blocks)))
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(cand), size=min(count, len(cand)), replace=False)
    return sorted(int(cand[i]) for i in pick)


def _rows_key(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return np.lexsort((a[:, 2], a[:, 1], a[:, 0]))


def _cloud_order(prog_points, inputs):
    """(the benchmark's row for each program row, rows that differ)."""
    P = prog_points.detach().cpu().numpy()
    X = inputs['points']
    if P.shape != X.shape:
        return None, abs(P.shape[0] - X.shape[0]) + 1
    ip, ix = _rows_key(P), _rows_key(X)
    differ = int((P[ip] != X[ix]).any(1).sum())
    order = np.empty_like(ip)
    order[ip] = ix
    return order, differ


def _rms(x):
    return float(torch.sqrt((x.double() ** 2).sum(1).mean()))


def _rows(a):
    a = np.ascontiguousarray(a, dtype=np.float32)
    return a.view(np.dtype((np.void, 12))).ravel()


def neck_miss(before, faces, after, low, high, dev, log, i):
    """The share of the vertices of ``before`` that the plain curvature
    puts clear past a threshold and that ``after`` still holds; None
    where the pass removes nothing by its definition."""
    pv = torch.from_numpy(before).to(dev).double()
    K = mesh_checks.gaussian_k(pv, torch.from_numpy(faces).to(dev))
    V = before.shape[0]
    loose = int(((K < low) | (K > high)).sum())
    flag = ((K < low * (1 + NECK_MARGIN))
            | (K > high * (1 + NECK_MARGIN))).cpu().numpy()
    n_flag = int(flag.sum())
    kept = int(np.isin(_rows(before[flag]), _rows(after)).sum())
    log(f'block {i}: neck pass got V={V}, {loose} past a threshold, '
        f'{n_flag} clear of it, {kept} of those left; V after '
        f'{after.shape[0]}')
    if loose > 0.25 * V:
        return None
    return kept / n_flag if n_flag else 0.0


def compare(state, final_mesh, config, workload, inputs, seed, truth,
            control=False, log=print):
    """{name: value} of :data:`NUMBERS`; ``log`` gets the details.
    ``truth`` is the module of the configuration's true shape
    (``harness.shape_module``).
    ``state`` holds what the spans captured of the last fit: ``blocks``
    (by block index), ``start`` (the first block's starting surface)
    and ``necks`` (the neck pass's surfaces, by the index of the block
    after it)."""
    captured = state['blocks']
    gaps, surf, edges, necks, n_def = [], [], [], [], 0
    lam0 = float(config['curvature_weight'] * config['kc'] / 2.0)
    shrink = float(config.get('shrink_weight', 0.0))
    blocks = schedule(workload)
    rng = np.random.default_rng([seed, 2])
    start = state['start']
    sigma_min = 1.0 / float(np.max(inputs['sigma_inv']))
    l0 = None
    if start is not None:
        l0 = mesh_checks.mean_edge(start['positions'].double(),
                                   start['faces'][start['f_mask'].bool()])
        log(f'first surface: mean edge {l0:.6g} nm')
    boundaries = remesh_boundaries(workload)
    for i in sorted(k for k, s in captured.items() if 'points' in s):
        s = captured[i]
        dev = s['positions'].device
        V = int(s['v_mask'].sum())
        F = int(s['f_mask'].sum())
        d = mesh_checks.defects(s['faces'][:F], V)
        d['mask'] = (mesh_checks.mask_defects(s['v_mask'])
                     + mesh_checks.mask_defects(s['f_mask']))
        order, d['cloud_rows'] = _cloud_order(s['points'], inputs)
        d['point_mask'] = int((~s['point_mask'].bool()).sum())
        want = (blocks[i][1] if i < len(blocks) else -1,
                static_iters(workload))
        d['schedule'] = int((s.get('active_iters'), s.get('num_iters'))
                            != want)
        n_def += sum(d.values())
        log(f'block {i}: V={V} F={F} defects {d}')
        j = blocks[i][0] if i < len(blocks) else -1
        if l0 is not None and j in boundaries:
            target = edge_target(config, workload, l0, sigma_min, j)
            e = mesh_checks.mean_edge(s['positions'].double(),
                                      s['faces'][:F])
            edges.append(abs(e / target - 1.0))
            log(f'block {i}: mean edge {e:.6g} nm, schedule '
                f'{target:.6g} nm at iteration {j}')
        if order is None:
            gaps.append(float('inf'))
            continue
        pts = torch.from_numpy(inputs['points'][order]).to(dev)
        sig = torch.from_numpy(inputs['sigma_inv'][order]).to(dev)
        wts = torch.from_numpy(inputs['weights'][order]).to(dev)
        pm = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        args = (s['positions'], s['faces'], s['f_mask'], s['v_mask'], pts,
                sig, wts, pm, lam0, shrink, want[1], want[0], shrink > 0,
                config['correspondence'])
        f_ref = ref.cg_block(*args, dtype=torch.float64)
        if control:
            got = ref.cg_block(*args, dtype=torch.bfloat16)
        else:
            got = s['result']
        vm = s['v_mask'].bool()
        step = _rms((f_ref - s['positions'].double())[vm])
        gap = _rms((got.double() - f_ref)[vm]) / max(step, 1e-30) \
            if V else float('inf')
        gaps.append(gap)
        log(f'block {i}: step rms {step:.6g} nm, gap rms '
            f'{gap * step:.6g} nm, block_gap {gap:.6g}')
        del f_ref, got
        if i in state['necks']:
            miss = neck_miss(*state['necks'][i],
                             config['neck_threshold_low'],
                             config['neck_threshold_high'], dev, log, i)
            if miss is not None:
                necks.append(miss)
        pre = captured.get(i - 1)
        if pre is None or pre['faces'] is s['faces']:
            continue
        pv = pre['result'][pre['v_mask'].bool()].double()
        pf = pre['faces'][pre['f_mask'].bool()]
        post = s['positions'][vm].double()
        if pv.shape[0] == 0 or pf.shape[0] == 0 or post.shape[0] == 0:
            surf.append(float('inf'))
            continue
        if post.shape[0] > SURFACE_SAMPLE:
            pick = rng.choice(post.shape[0], SURFACE_SAMPLE, replace=False)
            post = post[torch.from_numpy(pick).to(dev)]
        if control:
            post = post.to(torch.bfloat16).double()
        dist = mesh_checks.surface_distance(post, pv, pf)
        surf.append(float(torch.quantile(dist, 0.9)))
        log(f'block {i}: surgery 90th percentile {surf[-1]:.6g} nm, rms '
            f'{float(torch.sqrt((dist ** 2).mean())):.6g} nm, max '
            f'{float(dist.max()):.6g} nm over {post.shape[0]} vertices')
    shape_gap = float('inf')
    if final_mesh is not None:
        faces = torch.from_numpy(np.asarray(final_mesh.faces,
                                            dtype=np.int64))
        verts = torch.from_numpy(np.asarray(final_mesh.vertices,
                                            dtype=np.float64))
        d = mesh_checks.defects(faces, len(verts))
        n_def += sum(d.values())
        used = verts[torch.unique(faces.reshape(-1))] if faces.numel() \
            else verts[:0]
        if used.shape[0]:
            shape_gap = truth.gap(used, config['cloud'])
        log(f'final surface: V={len(verts)} F={len(faces)} defects {d}, '
            f'shape_gap {shape_gap:.6g} nm off the '
            f'{config["cloud"]["shape"]}')
        last = [b for b in boundaries if b <= workload['iterations']]
        if l0 is not None and last and faces.numel():
            target = edge_target(config, workload, l0, sigma_min, last[-1])
            e = mesh_checks.mean_edge(verts, faces)
            edges.append(abs(e / target - 1.0))
            log(f'final surface: mean edge {e:.6g} nm, schedule '
                f'{target:.6g} nm at iteration {last[-1]}')
    if not gaps:
        # nothing was captured: the fit ran fewer blocks than sampled
        n_def += 1
    return dict(block_gap=max(gaps) if gaps else float('inf'),
                surgery_gap=max(surf) if surf else 0.0,
                edge_gap=max(edges) if edges else (
                    float('inf') if boundaries else 0.0),
                neck_miss=max(necks) if necks else 0.0,
                shape_gap=shape_gap, defects=float(n_def))
