"""PyTorch port, the ordered segment sum: K2's plain version and
``segment_sum_ordered``, the one accumulation every sum of the fit goes
through, held to its order bit for bit on the CPU.

The order is: each segment is the float32 sum, from zero (or from
``init``), of its rows in ascending row index, rounded after every add.
The CUDA kernels (``csrc/scatter.cu``) repeat it and are held to the
plain versions on the card (``tests/test_torch_cuda.py``); here the
plain versions are held to a Python loop of float32 adds, to
``Tensor.index_add_`` on the CPU (the order they rest on: a change of
torch that changed it would fail here), and to the JAX package's
``segment_sum`` to a tolerance.  The former ``index_add_`` sites of the
port give the same bits as before, and no ``index_add_``,
``scatter_add`` or accumulating ``index_put_`` is left in the port
outside the plain ordered sum.
"""

import ast
import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ch_shrinkwrap_torch.mesh.core import TriangleMesh
from ch_shrinkwrap_torch.mesh.primitives import icosphere
from ch_shrinkwrap_torch.ops import correspondence as corr
from ch_shrinkwrap_torch.ops import cuda_scatter, meshdata, normals
from ch_shrinkwrap_torch.solver import shrinkwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'ch_shrinkwrap_torch')

S = 300            # segments
N = 24_000         # rows
BIG = 7            # the segment of 10,000 rows


@pytest.fixture(scope='module')
def rows():
    """Rows whose magnitudes span 1e-6 to 1e8 (so the order of the adds
    shows in the bits), one segment with 10,000 rows, rows dropped by a
    negative target and rows whose target is at or past ``S``."""
    rng = np.random.default_rng(11)
    scale = 10.0 ** rng.uniform(-6, 8, (N, 1))
    vals = (rng.normal(size=(N, 12)) * scale).astype(np.float32)
    w = (rng.uniform(0.1, 1.0, (N, 3)) * scale).astype(np.float32)
    res = (rng.normal(size=(N, 3)) * 10.0 ** rng.uniform(-6, 8, (N, 1))
           ).astype(np.float32)
    tgt = rng.integers(0, S, N)
    tgt[rng.choice(N, 10_000, replace=False)] = BIG
    tgt[rng.random(N) < 0.02] = -1
    tgt[rng.random(N) < 0.02] = S + 5
    return dict(vals=vals, w=w, res=res, tgt=tgt)


def loop_sum(x, tgt, n_seg, init=None):
    """The order itself: a Python loop of float32 adds, row by row."""
    out = (np.zeros((n_seg,) + x.shape[1:], np.float32) if init is None
           else init.copy())
    for n in range(x.shape[0]):
        t = tgt[n]
        if 0 <= t < n_seg:
            out[t] = out[t] + x[n]
    return out


def mode_rows(mode, r, C=12):
    """The mode's per-row products, each rounded to float32."""
    w, res = r['w'], r['res']
    if mode == 'given':
        return r['vals'][:, :C]
    cols = []
    if mode in ('ah', 'ahw2'):
        for j in range(3):
            cols += [w[:, j] * res[:, c] for c in range(3)] + [w[:, j]]
    if mode in ('ahw2', 'w2'):
        cols += [w[:, j] * w[:, k] for j, k in
                 ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
    return np.stack(cols, axis=1).astype(np.float32)


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def k2_args(r):
    """K2 inputs whose one window covers the whole 384-face table: a row
    with 0 <= fid < 384 routes to fid (and is dropped at or past S); a
    row with fid = -1 routes to sub_ids[js], or is dropped with js = -1.
    Returns the args and the targets they must route to."""
    rng = np.random.default_rng(12)
    tgt = r['tgt']
    fid = np.where((tgt >= 0) & (tgt < 384), tgt, -1).astype(np.int32)
    sub_ids = rng.permutation(S)[:64].astype(np.int32)
    js = np.full(N, -1, np.int32)
    to_sub = rng.random(N) < 0.05
    js[to_sub] = rng.integers(0, 64, int(to_sub.sum()))
    fid[to_sub] = -1
    want = np.where(fid >= 0, fid, np.where(js >= 0, sub_ids[js], -1))
    nb = -(-N // 256)
    starts = np.zeros((nb, 3), np.int32)
    t = torch.from_numpy
    return (t(fid), t(js), t(starts), t(sub_ids)), want


@pytest.mark.parametrize('impl', ['ordered', 'stepwise'])
@pytest.mark.parametrize('mode,C', [('ah', 12), ('ahw2', 18), ('w2', 6),
                                    ('given', 1), ('given', 5),
                                    ('given', 12)])
def test_modes_equal_a_float32_loop(rows, mode, C, impl):
    """The plain ordered sum (``segment_sum_ordered`` on the CPU, and the
    stepwise form the plain version takes on the card) of each mode's
    rows is the Python loop's sum bit for bit."""
    x = mode_rows(mode, rows, C)
    ref = loop_sum(x, rows['tgt'], S)
    fn = {'ordered': cuda_scatter.segment_sum_ordered,
          'stepwise': cuda_scatter.segment_sum_stepwise}[impl]
    out = fn(torch.from_numpy(x), torch.from_numpy(rows['tgt']), S)
    assert np.array_equal(bits(out), bits(ref))


@pytest.mark.parametrize('mode,C', [('ah', 12), ('ahw2', 18), ('w2', 6),
                                    ('given', 1), ('given', 5),
                                    ('given', 12)])
def test_k2_plain_modes_equal_a_float32_loop(rows, mode, C):
    """K2's plain version: its routing, then each face's rows in
    ascending row index, equal to the loop over the routed targets bit
    for bit, in the padded-stride table."""
    args, want = k2_args(rows)
    t = torch.from_numpy
    tgt = cuda_scatter.route(args[0], args[1], args[2], args[3], 384, 256,
                             False)
    assert np.array_equal(tgt.numpy(), want)
    out = cuda_scatter.windowed_scatter(
        mode, t(rows['w']), t(rows['res']) if mode in ('ah', 'ahw2')
        else None, t(rows['vals'][:, :C]) if mode == 'given' else None,
        *args, S)
    assert cuda_scatter.windowed_scatter.launches == 0
    assert out.stride(0) == -(-out.shape[1] // 4) * 4
    ref = loop_sum(mode_rows(mode, rows, C), want, S)
    assert np.array_equal(bits(out), bits(ref))


@pytest.mark.parametrize('init', [False, True])
@pytest.mark.parametrize('shape', ['1d', '2d'])
@pytest.mark.parametrize('threads', [1, 4])
def test_plain_order_is_index_add(rows, shape, init, threads):
    """The order the plain version rests on: ``Tensor.index_add_`` on the
    CPU adds each target's rows in ascending row index from the table's
    value, at one thread and at several; the stepwise form equals it."""
    x = rows['vals'][:, 3] if shape == '1d' else rows['vals'][:, :7]
    tgt = rows['tgt']
    rng = np.random.default_rng(13)
    base = (rng.normal(size=(S,) + x.shape[1:]) * 1e3).astype(np.float32)
    keep = (tgt >= 0) & (tgt < S)
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        table = torch.from_numpy(base.copy()) if init else \
            torch.zeros((S,) + x.shape[1:])
        lib = table.index_add_(0, torch.from_numpy(tgt[keep]),
                               torch.from_numpy(x[keep]))
        ini = torch.from_numpy(base) if init else None
        plain = cuda_scatter.segment_sum_ordered_plain(
            torch.from_numpy(x), torch.from_numpy(tgt), S, init=ini)
        step = cuda_scatter.segment_sum_stepwise(
            torch.from_numpy(x), torch.from_numpy(tgt), S, init=ini)
    finally:
        torch.set_num_threads(prev)
    ref = loop_sum(x, tgt, S, base if init else None)
    assert np.array_equal(bits(lib), bits(ref))
    assert np.array_equal(bits(plain), bits(ref))
    assert np.array_equal(bits(step), bits(ref))


@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_ordered_sum_matches_jax_segment_sum(rows, dtype):
    """Against the JAX package's accumulation (``jax.ops.segment_sum``,
    XLA on the CPU), on rows of one magnitude: XLA's order of the adds
    is its own, so to 1e-5 * max|ref|."""
    x = rows['vals'][:, :4] / 10.0 ** np.floor(
        np.log10(np.abs(rows['vals'][:, :1]) + 1e-30))
    x = x.astype(dtype)
    tgt = rows['tgt']
    ref = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x.astype(np.float32)), jnp.asarray(tgt),
        num_segments=S))
    out = cuda_scatter.segment_sum_ordered(torch.from_numpy(x),
                                           torch.from_numpy(tgt), S)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.numpy().astype(np.float32), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_empty_and_rejected_input():
    out = cuda_scatter.segment_sum_ordered(torch.zeros((0, 3)),
                                           torch.zeros(0, dtype=torch.long),
                                           5)
    assert out.shape == (5, 3) and not out.any()
    init = torch.arange(5.0)
    out = cuda_scatter.segment_sum_stepwise(torch.ones(3),
                                            torch.tensor([-1, 9, 5]), 5,
                                            init=init)
    assert torch.equal(out, init)
    with pytest.raises(ValueError):
        cuda_scatter.segment_sum_ordered(torch.zeros((4, 3)),
                                         torch.zeros(3, dtype=torch.long), 5)
    with pytest.raises(ValueError):
        cuda_scatter.segment_sum_ordered(torch.zeros((4, 3)),
                                         torch.zeros(4, dtype=torch.long), 5,
                                         init=torch.zeros((5, 2)))


# ---- no other accumulation in the port ---------------------------------

ALLOWED = {('ops/cuda_scatter.py', 'segment_sum_ordered_plain'),
           ('ops/cuda_scatter.py', 'segment_sum_stepwise')}
ACCUMULATING = {'index_add', 'index_add_', 'scatter_add', 'scatter_add_'}


def _accumulating_calls(path):
    """(line, enclosing function, call) of every accumulating call in a
    source file."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            name = node.func.attr
            acc = any(k.arg == 'accumulate' and not (
                isinstance(k.value, ast.Constant) and k.value.value is False)
                for k in node.keywords)
            if name in ACCUMULATING or (
                    name in ('index_put', 'index_put_', 'put_') and acc):
                found.append((node.lineno, func, name))
        for child in ast.iter_child_nodes(node):
            visit(child, func)

    visit(tree, None)
    return found


ATOMIC = re.compile(r'atomic[A-Z_]\w*|\batom\.|\bred\.|cuda::atomic')


def test_no_accumulation_outside_the_plain_ordered_sum():
    """No ``index_add``/``index_add_``, ``scatter_add`` or accumulating
    ``index_put_`` in the port outside the plain ordered sum, and no
    atomic in its CUDA sources: no ``atomicAdd`` nor any other
    ``atomic*`` function, no PTX ``atom.``/``red.``, no
    ``cuda::atomic``."""
    stray, seen = [], set()
    for root, _, files in os.walk(PKG):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, PKG)
            if name.endswith('.py'):
                for line, func, call in _accumulating_calls(path):
                    if (rel, func) in ALLOWED:
                        seen.add(func)
                    else:
                        stray.append(f'{rel}:{line} {func} {call}')
            elif name.endswith(('.cu', '.cuh')):
                with open(path) as fh:
                    src = fh.read()
                    if 'atomicAdd' in src:
                        stray.append(f'{rel}: atomicAdd')
                    stray += [f'{rel}: {m}' for m in ATOMIC.findall(src)]
    assert not stray, stray
    assert seen == {f for _, f in ALLOWED}


# ---- the card's ordering: its digit plan, and no library ordering ------

PLAN_SEGMENTS = [1, 127, 128, 129, 1023, 1024, 1025, 2 ** 19 + 1, 487_112,
                 2 ** 31 - 2]


@pytest.mark.parametrize('num_segments', PLAN_SEGMENTS)
def test_digit_plan_covers_the_keys(num_segments):
    """The radix ordering's digits cover ``bit_length(num_segments)``
    bits (the dropped-row key is ``num_segments`` itself), from bit 0 up
    without a gap, in the fewest passes of at most 10 bits, and each
    pass's shared memory fits the 48 KB a launch may take without the
    dynamic-memory attribute."""
    plan = cuda_scatter.digit_plan(num_segments)
    nbits = num_segments.bit_length()
    assert [s for s, _ in plan] == list(np.cumsum([0] + [b for _, b in
                                                         plan])[:-1])
    assert sum(b for _, b in plan) == nbits
    assert len(plan) == -(-nbits // cuda_scatter.RADIX_BITS_MAX)
    assert all(1 <= b <= cuda_scatter.RADIX_BITS_MAX for _, b in plan)
    assert max(b for _, b in plan) - min(b for _, b in plan) <= 1
    assert num_segments >> nbits == 0 and (num_segments - 1) >> nbits == 0
    assert all(cuda_scatter.radix_smem_bytes(b)
               <= cuda_scatter.SMEM_STATIC_MAX for _, b in plan)


def test_radix_order_on_the_cpu_is_segment_order():
    """On a CPU tensor the ordering is its plain version: int32 and
    int64 targets, rows dropped below 0 and at or past the table."""
    rng = np.random.default_rng(16)
    tgt = rng.integers(-3, S + 3, 5000)
    key = torch.from_numpy(np.where((tgt >= 0) & (tgt < S), tgt, S)
                           .astype(np.int32))
    perm, offsets = cuda_scatter.segment_order(key, S)
    for dt in (torch.int32, torch.int64):
        p2, o2 = cuda_scatter.radix_order(torch.from_numpy(tgt).to(dt), S)
        assert p2.dtype == torch.int32 and torch.equal(p2.long(), perm)
        assert torch.equal(o2, offsets)
    assert int(offsets[-1]) == int(((tgt >= 0) & (tgt < S)).sum())


CARD_PATHS = ('windowed_scatter', 'segment_sum_ordered')
LIBRARY_ORDERING = {'sort', 'argsort', 'searchsorted', 'segment_order',
                    'unique', 'unique_consecutive', 'msort', 'topk'}
PLAIN = {'windowed_scatter_plain', 'segment_sum_ordered_plain',
         'segment_sum_stepwise', 'segment_order', 'route', '_columns'}


def test_card_paths_call_no_library_ordering():
    """``windowed_scatter`` and ``segment_sum_ordered`` and every helper
    of this module they call (followed by name; the plain versions,
    which keep theirs, excepted) call no ``sort``, ``argsort``,
    ``searchsorted`` or ``segment_order``: the card orders its rows with
    the kernels alone."""
    with open(os.path.join(PKG, 'ops', 'cuda_scatter.py')) as fh:
        tree = ast.parse(fh.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def callee(node):
        f = node.func
        return f.attr if isinstance(f, ast.Attribute) else \
            f.id if isinstance(f, ast.Name) else None

    seen, todo, bad = set(), list(CARD_PATHS), []
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Call):
                c = callee(node)
                if c in LIBRARY_ORDERING:
                    bad.append(f'{name}:{node.lineno} {c}')
                elif c in funcs and c not in PLAIN:
                    todo.append(c)
    assert not bad, bad
    assert {'_order_args', 'digit_plan', '_check',
            '_check_segment'} <= seen
    # the plain versions keep their library ordering
    plain = {callee(n) for n in ast.walk(funcs['segment_order'])
             if isinstance(n, ast.Call)}
    assert {'sort', 'searchsorted'} <= plain


# ---- the plain versions at the kernels' segment lengths ----------------

LENGTHS = [0, 1, 31, 32, 33, 169, 942, 65_536, 'N']
N_LONG = 66_000
S_LONG = 2_000


@pytest.fixture(scope='module')
def long_rows():
    rng = np.random.default_rng(17)
    scale = 10.0 ** rng.uniform(-6, 8, (N_LONG, 1))
    return dict(
        rows=(rng.normal(size=(N_LONG, 3)) * scale).astype(np.float32),
        w=(rng.uniform(0.1, 1.0, (N_LONG, 3)) * scale).astype(np.float32),
        res=(rng.normal(size=(N_LONG, 3)) * scale).astype(np.float32),
        init=(rng.normal(size=(S_LONG, 3)) * 1e3).astype(np.float32))


def long_targets(L, seed=18):
    """Targets whose segment 5 has exactly L rows (all N_LONG for 'N'),
    the others a few each, and some rows dropped (below 0 and at or
    past S_LONG)."""
    rng = np.random.default_rng(seed)
    if L == 'N':
        return np.full(N_LONG, 5)
    tgt = rng.integers(6, S_LONG, N_LONG)
    tgt[rng.random(N_LONG) < 0.01] = -1
    tgt[rng.random(N_LONG) < 0.01] = S_LONG
    tgt[rng.choice(N_LONG, L, replace=False)] = 5
    return tgt


@pytest.mark.parametrize('L', LENGTHS)
def test_plain_versions_at_segment_lengths(long_rows, L):
    """The plain versions where one segment has L rows (the lengths at
    which the card's reduce changes hands between a lane and a warp, the
    path's 169 and 942, 65,536 and every row): K2s with and without
    ``init`` and K2 in 'ah' mode equal the Python loop of float32 adds
    bit for bit."""
    t = torch.from_numpy
    tgt = long_targets(L)
    assert int((tgt == 5).sum()) == (N_LONG if L == 'N' else L)
    x, init = long_rows['rows'], long_rows['init']
    for ini in (None, init):
        out = cuda_scatter.segment_sum_ordered(
            t(x), t(tgt), S_LONG, init=None if ini is None else t(ini))
        assert np.array_equal(bits(out), bits(loop_sum(x, tgt, S_LONG,
                                                       ini)))
    # K2: every row in its block's one window, so it routes to its face
    fid = np.where((tgt >= 0) & (tgt < S_LONG), tgt, S_LONG).astype(
        np.int32)
    starts = np.zeros((-(-N_LONG // 256), 3), np.int32)
    w, res = long_rows['w'], long_rows['res']
    out = cuda_scatter.windowed_scatter(
        'ah', t(w), t(res), None, t(fid), t(np.full(N_LONG, -1, np.int32)),
        t(starts), t(np.arange(8, dtype=np.int32)), S_LONG,
        window=S_LONG + 128)
    ref = loop_sum(mode_rows('ah', dict(w=w, res=res)), fid, S_LONG)
    assert np.array_equal(bits(out), bits(ref))


# ---- the former index_add_ sites give the same bits --------------------

@pytest.fixture(scope='module')
def small_mesh():
    rng = np.random.default_rng(14)
    v, f = icosphere(3, radius=50.0)
    v = (v + rng.normal(scale=0.5, size=v.shape)).astype(np.float32)
    ma = meshdata.from_mesh(TriangleMesh(v, f), quantum=256, device='cpu')
    return ma


def _site(name, ma):
    """(the site's output now, the same computed as before, with
    ``index_add``/``index_add_``)."""
    rng = np.random.default_rng(15)
    Vp, Fp = ma.positions.shape[0], ma.faces.shape[0]
    t = torch.from_numpy
    faces_l = ma.faces.reshape(-1).long()
    if name == 'vertex_normals':
        corners = normals.vertex_normal_corners(ma.positions, ma.faces,
                                                ma.f_mask)
        vn = torch.zeros((Vp, 3)).index_add_(0, faces_l,
                                             corners.reshape(-1, 3))
        return (normals.vertex_normals(ma.positions, ma.faces, ma.f_mask,
                                       Vp),
                normals.normalize_vertex_normals(vn))
    if name == 'vertex_areas':
        _, areas = normals.face_geometry(ma.positions, ma.faces, ma.f_mask)
        old = torch.zeros(Vp).index_add_(
            0, faces_l, areas[:, None].expand(-1, 3).reshape(-1))
        return normals.vertex_areas(ma.positions, ma.faces, ma.f_mask,
                                    Vp), old
    if name == 'fold':
        fused = t(rng.normal(size=(3 * Fp, 7)).astype(np.float32))
        old = torch.zeros((Vp, 7)).index_add_(0, faces_l, fused)
        return shrinkwrap._fold(fused, ma.faces, Vp, None), old
    if name == 'fold_overflow':
        # an incidence table five wide, so vertices of valence 6 overflow
        fused = t(rng.normal(size=(3 * Fp, 7)).astype(np.float32))
        inc, ov_r, ov_v = meshdata.incidence_table(
            ma.host['faces'], ma.host['f_mask'], Vp, K=5)
        assert len(ov_r) > 0
        g = meshdata.gather_tables(ma)._replace(
            fold_idx=t(np.clip(inc, 0, None).reshape(-1).astype(np.int32)),
            fold_care=t(inc >= 0),
            fold_ov=(t(ov_r).long(), t(ov_v).long()))
        from ch_shrinkwrap_torch.ops import cuda_gather
        old = cuda_gather.row_group_sum(fused, g.fold_idx, g.fold_care)
        old = old.index_add(0, g.fold_ov[1], fused[g.fold_ov[0]])
        return shrinkwrap._fold(fused, ma.faces, Vp, g), old
    if name == 'ah_apply':
        n = 2000
        v_idx = t(rng.integers(0, Vp, (n, 3)))
        w = t(rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32))
        r = t(rng.normal(size=(n, 3)).astype(np.float32))
        vals = (w[..., None] * r[:, None, :]).reshape(-1, 3)
        old = torch.zeros((Vp, 3)).index_add_(0, v_idx.reshape(-1), vals)
        return corr.ah_apply(r, v_idx, w, Vp), old
    if name == 'windowed_segment_sum':
        n = 3000
        vals = t(rng.normal(size=(n, 5)).astype(np.float32))
        fid = t(rng.integers(0, Fp, n).astype(np.int32))
        meta = corr.WindowedMeta(
            starts=t(rng.integers(0, Fp, (-(-n // 256), 3)).astype(
                np.int32)),
            js=t(rng.integers(-1, 64, n).astype(np.int32)),
            sub_ids=t(rng.permutation(Fp)[:64].astype(np.int32)))
        W = min(corr.CORR_W, -(-Fp // 128) * 128)
        tgt = cuda_scatter.route(fid, meta.js, meta.starts, meta.sub_ids, W,
                                 256, False)
        keep = (tgt >= 0) & (tgt < Fp)
        old = torch.zeros((Fp, 5)).index_add_(0, tgt[keep], vals[keep])
        return corr.windowed_segment_sum(vals, fid, meta, Fp), old
    if name == 'brute_ah':
        n = 2000
        per_corner = t(rng.normal(size=(n, 12)).astype(np.float32))
        fi = t(rng.integers(0, Fp, n))
        old = torch.zeros((Fp, 12)).index_add_(0, fi, per_corner)
        return cuda_scatter.segment_sum_ordered(per_corner, fi, Fp), old
    assert name == 'ncc_overflow'
    K = 20
    f = t(rng.normal(size=(Vp, 3)).astype(np.float32))
    vn = torch.nn.functional.normalize(
        t(rng.normal(size=(Vp, 3)).astype(np.float32)), dim=1)
    pi = t(rng.random(Vp).astype(np.float32))
    v_mask = torch.ones(Vp, dtype=torch.bool)
    v_mask[-10:] = False
    nbr = rng.integers(0, Vp, size=(Vp, K)).astype(np.int32)
    nbr[rng.random((Vp, K)) < 0.4] = -1
    from ch_shrinkwrap_torch.convert import state_from_numpy
    st = state_from_numpy(positions=f.numpy(), v_mask=v_mask.numpy(),
                          faces=np.zeros((8, 3), np.int32),
                          f_mask=np.zeros(8, bool), nbr_v=nbr, device='cpu')
    g = meshdata.gather_tables(st.ma)
    assert g.ncc_ov is not None
    args = (f, t(nbr), vn, pi, v_mask)
    kmajor = (g.ncc_idx, g.ncc_care, g.ncc_ov)
    now = shrinkwrap.compute_ncc(*args, kmajor=kmajor)
    saved = cuda_scatter.segment_sum_ordered
    # the overflow terms as the k-major form added them before
    cuda_scatter.segment_sum_ordered = \
        lambda rows, target, n, init=None: init.index_add(0, target, rows)
    try:
        old = shrinkwrap.compute_ncc(*args, kmajor=kmajor)
    finally:
        cuda_scatter.segment_sum_ordered = saved
    return now, old


SITES = ['vertex_normals', 'vertex_areas', 'fold', 'fold_overflow',
         'ah_apply', 'windowed_segment_sum', 'brute_ah', 'ncc_overflow']


@pytest.mark.parametrize('impl', ['ordered', 'stepwise'])
@pytest.mark.parametrize('name', SITES)
def test_former_sites_give_the_same_bits(small_mesh, name, impl):
    """Each accumulation that was an ``index_add``/``index_add_`` gives
    the bits it gave before, through the plain ordered sum and through
    the stepwise form the plain version takes on the card."""
    saved = cuda_scatter.segment_sum_ordered
    if impl == 'stepwise':
        cuda_scatter.segment_sum_ordered = cuda_scatter.segment_sum_stepwise
    try:
        now, old = _site(name, small_mesh)
    finally:
        cuda_scatter.segment_sum_ordered = saved
    assert now.shape == old.shape
    assert np.array_equal(bits(now), bits(old))
