"""PyTorch port, the CUDA kernels on the card against their plain
versions.  Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; skips
elsewhere.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

from the repository's root (``--noconftest``: the suite's conftest
configures JAX, which a PyTorch-only install need not have; this file
imports only the port, and the K1 and brute-force cases of
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def sphere_cloud(n, radius=50.0, sigma=3.0, seed=0, far=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = d * radius + rng.normal(scale=sigma, size=(n, 3))
    if far:
        pts = np.vstack([pts, rng.uniform(-3 * radius, 3 * radius,
                                          (far, 3))])
    return pts.astype(np.float32)


@pytest.fixture(scope='module')
def problem(dev):
    from ch_shrinkwrap_torch.mesh.core import TriangleMesh
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.ops import correspondence as corr
    from ch_shrinkwrap_torch.ops import meshdata
    from ch_shrinkwrap_torch.ops.ordering import fit_point_order
    v, f = icosphere(5, radius=50.0)
    mesh = TriangleMesh(v, f)
    mesh.spatial_sort()
    ma = meshdata.from_mesh(mesh, quantum=256, hilbert_faces=False,
                            device=dev)
    pts = sphere_cloud(60_000, far=2000)
    pts = torch.from_numpy(pts[fit_point_order(pts)]).to(dev)
    centers = ma.positions[ma.faces.long()].mean(1)
    starts = corr.windowed_anchor_starts(pts, centers, ma.f_mask)
    prep = corr.windowed_points_prep(pts)
    Fp = ma.faces.shape[0]
    sub = torch.from_numpy(corr._subsample_ids(Fp, 1024)).to(dev)
    return dict(ma=ma, pts=pts, centers=centers, starts=starts, prep=prep,
                sub=sub, c2=corr._masked_c2(centers, ma.f_mask),
                W=min(corr.CORR_W, -(-Fp // 128) * 128), Fp=Fp)


def test_window_min_kernel_matches_plain(problem):
    from ch_shrinkwrap_torch.ops import cuda_window
    p = problem
    args = (p['prep'].blocks_t, p['starts'], p['centers'].T.contiguous(),
            p['c2'], p['sub'], p['W'], 3)
    n0 = cuda_window.window_min.launches
    d2k, fk, jk = cuda_window.window_min(*args)
    torch.cuda.synchronize()
    assert cuda_window.window_min.launches == n0 + 1
    d2p, fp, jp = cuda_window.window_min_plain(*args)
    # the kernel repeats the plain version's fp32 arithmetic exactly
    assert torch.equal(fk, fp) and torch.equal(jk, jp)
    assert torch.equal(d2k.view(torch.int32), d2p.view(torch.int32))


@pytest.mark.parametrize('W,nsub,nb,B', [(256, 64, 1, 256),
                                         (1024, 64, 3, 256),
                                         (1004, 60, 2, 256),
                                         (2048, 1024, 1, 100),
                                         (512, 64, 2, 300)])
def test_window_min_kernel_shapes(dev, W, nsub, nb, B):
    """Bit-equal to the plain version, on the card and on the CPU,
    where W and nsub are no multiples of the staging tile or the chunk,
    for one block, and for blocks of fewer or more than one CUDA
    block's 256 points."""
    from ch_shrinkwrap_torch.ops import correspondence as corr
    from ch_shrinkwrap_torch.ops import cuda_window
    rng = np.random.default_rng(W + nsub + nb + B)
    Fp = 4 * max(W, 1024)
    cen = (rng.normal(size=(3, Fp)) * 500.0).astype(np.float32)
    pts = (rng.normal(size=(nb, 3, B)) * 500.0).astype(np.float32)
    starts = rng.integers(0, Fp - W + 1, (nb, 3)).astype(np.int32)
    c2 = corr.sumsq3(torch.from_numpy(cen.T.copy())).to(dev)
    args = (torch.from_numpy(pts).to(dev), torch.from_numpy(starts).to(dev),
            torch.from_numpy(cen).to(dev), c2,
            corr.subsample_ids(Fp, nsub, dev), W, 3)
    out_k = cuda_window.window_min(*args)
    out_p = cuda_window.window_min_plain(*args)
    out_c = cuda_window.window_min_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args))
    for a_, b_, c_ in zip(out_k, out_p, out_c):
        assert torch.equal(a_.view(torch.int32), b_.view(torch.int32))
        assert torch.equal(a_.cpu().view(torch.int32), c_.view(torch.int32))


def test_window_min_ties_take_first_index(dev):
    """Exact ties go to the first minimum in concatenation order in the
    kernel and in its plain version on the card, also where the two
    tied faces straddle a chunk, two thread groups' spans or a staging
    tile of the kernel's schedule; on an integer lattice, where ties are
    everywhere, kernel, plain version on the card and plain version on
    the CPU agree on every output."""
    from chip_smoke import k1_boundary_cases, k1_lattice_case, \
        k1_tie_cases
    from ch_shrinkwrap_torch.ops import cuda_window
    for name, args, fid, js in (
            *k1_tie_cases(dev),
            *k1_boundary_cases(dev, cuda_window.schedule())):
        for fn in (cuda_window.window_min, cuda_window.window_min_plain):
            _, f_, j_ = fn(*args)
            assert bool((f_ == fid).all()) and bool((j_ == js).all()), \
                (name, fn.__name__, int(f_[0, 0]), int(j_[0, 0]))
    lat = k1_lattice_case(dev)
    out_k = cuda_window.window_min(*lat)
    out_p = cuda_window.window_min_plain(*lat)
    out_c = cuda_window.window_min_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in lat))
    for a_, b_, c_ in zip(out_k, out_p, out_c):
        assert torch.equal(a_, b_) and torch.equal(a_.cpu(), c_)


def _brute_same(args):
    """The brute-force kernel against its plain version on the card:
    ids and distances equal bit for bit, one launch a call.  Returns
    the kernel's (dist, idx)."""
    from ch_shrinkwrap_torch.ops import cuda_brute
    n0 = cuda_brute.brute_min.launches
    dk, ik = cuda_brute.brute_min(*args)
    torch.cuda.synchronize()
    assert cuda_brute.brute_min.launches == n0 + 1
    dp, ip = cuda_brute.brute_min_plain(*args)
    assert torch.equal(ik, ip)
    assert same_bits(dk, dp)
    return dk, ik


def test_brute_min_kernel_matches_plain(problem):
    """The icosphere problem's 62k points against its padded faces."""
    p = problem
    _brute_same((p['pts'], p['centers'], p['ma'].f_mask))


def test_brute_min_kernel_at_the_sweep_shape(dev):
    """~2e4 points against 70,656 faces, masked rows interleaved and at
    the end; and through nearest_face_bruteforce, which launches it."""
    from chip_smoke import brute_case
    from ch_shrinkwrap_torch.ops import correspondence as corr
    from ch_shrinkwrap_torch.ops import cuda_brute
    args = brute_case(dev)
    dk, ik = _brute_same(args)
    assert args[2][ik.long()].all()
    n0 = cuda_brute.brute_min.launches
    d, i = corr.nearest_face_bruteforce(*args)
    assert cuda_brute.brute_min.launches == n0 + 1
    assert torch.equal(i, ik) and same_bits(d, dk)


def test_brute_min_ties_take_the_lowest_id(dev):
    """Duplicated face centres on the seams of the schedule and of the
    face splits: the lowest valid id wins in the kernel and in its
    plain version; on an integer lattice, where ties are everywhere,
    the two agree on every output."""
    from chip_smoke import brute_lattice_case, brute_tie_case
    *args, want = brute_tie_case(dev)
    _, ik = _brute_same(args)
    assert torch.equal(ik, want)
    _brute_same(brute_lattice_case(dev))


@pytest.mark.parametrize('n_faces', [0, 1, 5000])
def test_brute_min_every_face_masked(dev, n_faces):
    """No valid face: the plain version's (BIG, 0) sentinel, sqrt(BIG)
    and id 0, for every point."""
    from chip_smoke import brute_case
    from ch_shrinkwrap_torch.ops import correspondence as corr
    pts, cen, mask = brute_case(dev, n_points=700, n_faces=max(n_faces, 1))
    args = (pts, cen[:n_faces], torch.zeros_like(mask[:n_faces]))
    dk, ik = _brute_same(args)
    assert not ik.any()
    big = torch.tensor(corr.BIG, dtype=torch.float32, device=dev)
    assert same_bits(dk, torch.sqrt(big).expand_as(dk))


# points: one below and above a thread's stride (64), a block (256) and
# two blocks; faces: a chunk (8), a thread group's span (256), a staging
# tile (1024) and the face splits (2048, 4096 faces and up)
BRUTE_N = [1, 63, 65, 255, 257, 511, 513]
BRUTE_FP = [7, 9, 255, 257, 1023, 1025, 2047, 2049, 4095, 4097, 6145,
            16385]


@pytest.mark.parametrize('n_points', BRUTE_N)
def test_brute_min_kernel_shapes(dev, n_points):
    from chip_smoke import brute_case
    for n_faces in BRUTE_FP:
        _brute_same(brute_case(dev, n_points=n_points, n_faces=n_faces,
                               seed=n_points + n_faces))


@pytest.mark.parametrize('mode', ['ah', 'ahw2', 'w2', 'given'])
def test_windowed_scatter_kernel_matches_plain(problem, mode):
    from ch_shrinkwrap_torch.ops import cuda_scatter
    from ch_shrinkwrap_torch.ops import correspondence as corr
    p = problem
    ma, N = p['ma'], p['pts'].shape[0]
    _, fid0, meta = corr.nearest_face_windowed(
        p['pts'], p['centers'], ma.f_mask, return_meta=True,
        starts=p['starts'], prep=p['prep'])
    # the polish moves some faces out of every window
    _, fid = corr.refine_correspondence(p['pts'], p['centers'],
                                        ma.face_nbrs, fid0, n_iter=2)
    g = torch.Generator(device=p['pts'].device).manual_seed(1)
    w = torch.rand((N, 3), generator=g, device=fid.device) + 0.1
    res = torch.randn((N, 3), generator=g, device=fid.device)
    vals = torch.randn((N, 12), generator=g, device=fid.device)
    args = (mode, w, res if mode in ('ah', 'ahw2') else None,
            vals if mode == 'given' else None, fid, meta.js, meta.starts,
            meta.sub_ids, p['Fp'])
    n0 = cuda_scatter.windowed_scatter.launches
    out = cuda_scatter.windowed_scatter(*args)
    torch.cuda.synchronize()
    assert cuda_scatter.windowed_scatter.launches == n0 + 1
    # each face's rows in ascending row index, as the plain version adds
    # them: equal bit for bit, on the card and on a CPU copy
    ref = cuda_scatter.windowed_scatter_plain(*_cpu(args))
    assert same_bits(out, ref)
    assert same_bits(out, cuda_scatter.windowed_scatter_plain(*args))
    # and the same bits on every launch
    assert same_bits(out, cuda_scatter.windowed_scatter(*args))


def _cpu(args):
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def same_bits(a, b):
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    as_int = torch.int64 if a.element_size() == 8 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(as_int),
                                              b.view(as_int))


def _scatter_case(dev, N, targets, C_given=12, seed=0):
    """K2 inputs whose rows all lie inside their block's one window, so
    row n goes to face targets[n]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = -(-N // 256)
    fid = targets.int()
    starts = torch.zeros((nb, 3), dtype=torch.int32, device=dev)
    js = torch.zeros(N, dtype=torch.int32, device=dev)
    sub = torch.arange(64, dtype=torch.int32, device=dev)
    w = torch.rand((N, 3), generator=g, device=dev) + 0.1
    res = torch.randn((N, 3), generator=g, device=dev)
    vals = torch.randn((N, C_given), generator=g, device=dev)
    return w, res, vals, fid, js, starts, sub


@pytest.mark.parametrize('case', ['one_face', 'runs', 'interleaved',
                                  'unaligned'])
@pytest.mark.parametrize('mode', ['ah', 'ahw2', 'w2', 'given'])
def test_windowed_scatter_preaggregation(dev, mode, case):
    """65,536 rows on one face (one long serial segment), runs of equal
    faces, faces that repeat out of order within a warp, and a row count
    that is no multiple of the warp or the block: bit-equal to the plain
    version on a CPU copy."""
    from ch_shrinkwrap_torch.ops import cuda_scatter
    N = 100_003 if case == 'unaligned' else 65_536
    n = torch.arange(N, device=dev)
    targets = {'one_face': torch.full_like(n, 17),
               'runs': n // 7,
               'interleaved': (n * 5) % 3 + 32 * (n // 32),
               'unaligned': n // 2}[case]
    Fp = 2048 if case == 'one_face' else int(targets.max()) + 1
    w, res, vals, fid, js, starts, sub = _scatter_case(
        dev, N, targets, C_given=5 if case == 'unaligned' else 12)
    if case != 'one_face':
        # every row in a window of its block
        blk = torch.arange(starts.shape[0], device=dev)
        first = targets[torch.clamp(blk * 256, max=N - 1)].int()
        starts = ((first // 128) * 128)[:, None].expand(-1, 3)
        starts = starts.contiguous()
    args = (mode, w, res if mode in ('ah', 'ahw2') else None,
            vals if mode == 'given' else None, fid, js, starts, sub, Fp)
    out = cuda_scatter.windowed_scatter(*args)
    ref = cuda_scatter.windowed_scatter_plain(*args)
    tgt = cuda_scatter.route(fid, js, starts, sub, min(2048, Fp), 256,
                             False)
    assert bool((tgt == fid.long()).all())
    C = ref.shape[1]
    assert out.shape == ref.shape and out.stride(0) == -(-C // 4) * 4
    assert same_bits(out, ref)
    assert same_bits(out, cuda_scatter.windowed_scatter_plain(*_cpu(args)))


@pytest.mark.parametrize('case', ['one_face', 'runs', 'interleaved'])
@pytest.mark.parametrize('C', [1, 3, 7, 12])
def test_segment_sum_ordered_matches_plain(dev, case, C):
    """The ordered segment sum on K2's adversarial targets (65,536 rows
    on one segment, runs, targets that repeat out of order), with rows
    dropped by a negative target or one past the table: bit-equal to
    its plain version on a CPU copy, with and without ``init``, and the
    same on a second launch."""
    from ch_shrinkwrap_torch.ops import cuda_scatter
    N = 65_536
    n = torch.arange(N, device=dev)
    targets = {'one_face': torch.full_like(n, 17),
               'runs': n // 7,
               'interleaved': (n * 5) % 3 + 32 * (n // 32)}[case]
    S = 2048 if case == 'one_face' else int(targets.max()) + 1
    g = torch.Generator(device=dev).manual_seed(C)
    targets = torch.where(torch.rand(N, generator=g, device=dev) < 0.01,
                          -1, targets)
    targets[:5] = S
    scale = 10.0 ** (torch.rand((N, 1), generator=g, device=dev) * 14 - 6)
    rows = torch.randn((N, C), generator=g, device=dev) * scale
    if C == 1:
        rows = rows[:, 0]
    init = torch.randn((S,) + tuple(rows.shape[1:]), generator=g,
                       device=dev)
    for ini in (None, init):
        n0 = cuda_scatter.segment_sum_ordered.launches
        out = cuda_scatter.segment_sum_ordered(rows, targets, S, init=ini)
        torch.cuda.synchronize()
        assert cuda_scatter.segment_sum_ordered.launches == n0 + 1
        ref = cuda_scatter.segment_sum_ordered_plain(
            rows.cpu(), targets.cpu(), S,
            init=None if ini is None else ini.cpu())
        assert same_bits(out, ref)
        assert same_bits(out, cuda_scatter.segment_sum_ordered(
            rows, targets, S, init=ini))
    step = cuda_scatter.segment_sum_stepwise(rows, targets, S)
    assert same_bits(step, cuda_scatter.segment_sum_ordered(rows, targets,
                                                            S))
    with pytest.raises(TypeError):
        cuda_scatter.segment_sum_ordered(rows.double(), targets, S)


@pytest.mark.parametrize('C', [1, 3, 7, 9, 16])
def test_row_gather_kernel_is_exact(dev, C):
    from ch_shrinkwrap_torch.ops import cuda_gather
    g = torch.Generator(device=dev).manual_seed(C)
    V, R = 50_000, 400_000
    src = torch.randn((V, C), generator=g, device=dev)
    idx = torch.randint(-5, V + 5, (R,), generator=g, device=dev,
                        dtype=torch.int32)
    n0 = cuda_gather.row_gather.launches
    out = cuda_gather.row_gather(src, idx)
    torch.cuda.synchronize()
    assert cuda_gather.row_gather.launches == n0 + 1
    assert torch.equal(out, cuda_gather.row_gather_plain(src, idx))


@pytest.mark.parametrize('K,C', [(8, 7), (5, 7), (8, 3), (16, 16)])
def test_row_group_sum_kernel_exact_order(dev, K, C):
    """The fused group sum adds a row's K source rows in the order
    k = 0..K-1: equal, bit for bit, to that sequential f32 sum (masked
    slots and indices outside [0, V) add nothing) and to the plain
    version, which adds in that order too."""
    from ch_shrinkwrap_torch.ops import cuda_gather
    g = torch.Generator(device=dev).manual_seed(K * 100 + C)
    V, R = 40_000, 100_003
    src = torch.randn((V, C), generator=g, device=dev)
    idx = torch.randint(-3, V + 3, (R * K,), generator=g, device=dev,
                        dtype=torch.int32)
    care = torch.rand((R, K), generator=g, device=dev) < 0.8
    n0 = cuda_gather.row_group_sum.launches
    out = cuda_gather.row_group_sum(src, idx, care)
    torch.cuda.synchronize()
    assert cuda_gather.row_group_sum.launches == n0 + 1
    rows = cuda_gather.row_gather_plain(src, idx).reshape(R, K, C)
    seq = torch.zeros((R, C), device=dev)
    for k in range(K):
        seq = torch.where(care[:, k, None], seq + rows[:, k], seq)
    assert torch.equal(out, seq)
    assert same_bits(out, cuda_gather.row_group_sum_plain(src, idx, care))
    assert same_bits(out, cuda_gather.row_group_sum_plain(
        src.cpu(), idx.cpu(), care.cpu()))
    ints = torch.randint(-50, 50, (V, C), generator=g, device=dev).float()
    assert torch.equal(cuda_gather.row_group_sum(ints, idx, care),
                       cuda_gather.row_group_sum_plain(ints, idx, care))


def test_fit_on_the_card_launches_every_kernel(dev):
    """A small windowed fit with every gather through K3: accuracy
    bounds of the CPU fit, and each kernel launched."""
    from ch_shrinkwrap_torch.mesh.primitives import icosphere
    from ch_shrinkwrap_torch.models import MembraneMesh
    from ch_shrinkwrap_torch.ops import cuda_window, cuda_scatter
    from ch_shrinkwrap_torch.ops import cuda_gather
    pts = sphere_cloud(50_000, seed=4)
    v, f = icosphere(3, radius=60.0)
    m = MembraneMesh(v, f, kc=1.0, step_size=4.0, remesh_frequency=5,
                     delaunay_remesh_frequency=0, device=dev)
    m.corr_method = 'windowed'
    m.ring_gather_min_verts = 0
    kernels = (cuda_window.window_min, cuda_scatter.windowed_scatter,
               cuda_gather.row_gather, cuda_gather.row_group_sum)
    before = [k.launches for k in kernels]
    m.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=4.0)
    assert all(k.launches > b for k, b in zip(kernels, before))
    r = np.linalg.norm(m.vertices, axis=1)
    assert abs(r.mean() - 50.0) < 1.5
    assert m.euler_characteristic == 2 and m.is_manifold


# ---- the radix ordering and the reduce of K2 and K2s ------------------

ORDER_CASES = ['path', 'adversarial', 'all_dropped', 'one_segment',
               'unaligned'] + [f'S{s}' for s in (1, 127, 128, 129, 1023,
                                                  1024, 1025, 2 ** 19 + 1)]


def _order_targets(case, dev):
    """(targets int64, num_segments) of one ordering case: path-like
    targets (a slow random walk over 487,112 faces, as K1's face ids of
    a sorted cloud), 44,839 rows on one face among them, every row
    dropped, one segment, N no multiple of the 4096-row tile, and
    random targets over tables whose key widths straddle a power of
    two; rows dropped below 0 and at or past the table."""
    g = torch.Generator(device=dev).manual_seed(len(case))
    N = 1_000_000
    if case in ('path', 'adversarial'):
        S = 487_112
        step = torch.randint(-1, 3, (N,), generator=g, device=dev)
        t = torch.clamp(torch.cumsum(step, 0) // 4, 0, S - 1)
        if case == 'adversarial':
            t[torch.randperm(N, generator=g, device=dev)[:44_839]] = 77
    elif case == 'all_dropped':
        S = 1000
        t = torch.full((N,), -1, device=dev)
        t[::2] = S
    elif case == 'one_segment':
        S = 4096
        t = torch.full((N,), 4095, device=dev)
    elif case == 'unaligned':
        S, N = 50_000, 100_003
        t = torch.randint(0, S, (N,), generator=g, device=dev)
    else:
        S, N = int(case[1:]), 300_001
        t = torch.randint(0, S, (N,), generator=g, device=dev)
    drop = torch.rand(N, generator=g, device=dev) < 0.01
    t = torch.where(drop, torch.randint(-2, 0, (N,), generator=g,
                                        device=dev), t)
    t[:3] = S
    return t, S


@pytest.mark.parametrize('case', ORDER_CASES)
def test_radix_order_equals_segment_order(dev, case):
    """The kernels' stable radix ordering gives ``segment_order``'s
    ``perm`` and ``offsets`` exactly, from int32 and int64 targets, and
    the same on a second launch."""
    from ch_shrinkwrap_torch.ops import cuda_scatter
    t, S = _order_targets(case, dev)
    key = torch.where((t >= 0) & (t < S), t, S).int()
    perm, offsets = cuda_scatter.segment_order(key, S)
    for tt in (t, t.int()):
        p2, o2 = cuda_scatter.radix_order(tt, S)
        torch.cuda.synchronize()
        assert p2.dtype == torch.int32 and o2.dtype == torch.int32
        assert torch.equal(p2.long(), perm), case
        assert torch.equal(o2, offsets), case
    p3, o3 = cuda_scatter.radix_order(t, S)
    assert torch.equal(p3.long(), perm) and torch.equal(o3, offsets)


SEG_LENGTHS = [0, 1, 31, 32, 33, 169, 942, 65_536, 'N']


def _long_case(dev, L, N=200_000, S=3000):
    """Targets whose segment 9 has exactly L rows (every row for 'N'),
    the others a few each, 1% dropped; rows of magnitudes 1e-6 to 1e8,
    so the order of the adds shows in the bits."""
    g = torch.Generator(device=dev).manual_seed(7)
    if L == 'N':
        t = torch.full((N,), 9, device=dev)
    else:
        t = torch.randint(10, S, (N,), generator=g, device=dev)
        t[torch.rand(N, generator=g, device=dev) < 0.01] = -1
        t[torch.randperm(N, generator=g, device=dev)[:L]] = 9
    scale = 10.0 ** (torch.rand((N, 1), generator=g, device=dev) * 14 - 6)
    return t, S, scale, g


@pytest.mark.parametrize('L', SEG_LENGTHS)
@pytest.mark.parametrize('mode', ['ah', 'ahw2', 'w2', 'given'])
def test_windowed_scatter_segment_lengths(dev, mode, L):
    """K2 where one face has L rows: bit-equal to the plain version on a
    CPU copy, and the same on a second launch."""
    from ch_shrinkwrap_torch.ops import cuda_scatter
    t, S, scale, g = _long_case(dev, L)
    N = t.shape[0]
    fid = torch.where(t >= 0, t, S).int()
    starts = torch.zeros((-(-N // 256), 3), dtype=torch.int32, device=dev)
    js = torch.full((N,), -1, dtype=torch.int32, device=dev)
    sub = torch.arange(64, dtype=torch.int32, device=dev)
    w = (torch.rand((N, 3), generator=g, device=dev) + 0.1) * scale
    res = torch.randn((N, 3), generator=g, device=dev) * scale
    vals = torch.randn((N, 11), generator=g, device=dev) * scale
    args = (mode, w, res if mode in ('ah', 'ahw2') else None,
            vals if mode == 'given' else None, fid, js, starts, sub, S,
            256, S + 128)
    out = cuda_scatter.windowed_scatter(*args)
    ref = cuda_scatter.windowed_scatter_plain(*_cpu(args))
    assert bool((ref[9] != 0).any()) == (L != 0)
    assert same_bits(out, ref)
    assert same_bits(out, cuda_scatter.windowed_scatter(*args))


@pytest.mark.parametrize('L', SEG_LENGTHS)
@pytest.mark.parametrize('C', [1, 3, 7, 12, 29])
def test_segment_sum_ordered_segment_lengths(dev, C, L):
    """K2s where one segment has L rows, at widths on both sides of its
    column chunks, with and without ``init``: bit-equal to the plain
    version on a CPU copy, and the same on a second launch."""
    from ch_shrinkwrap_torch.ops import cuda_scatter
    t, S, scale, g = _long_case(dev, L)
    rows = torch.randn((t.shape[0], C), generator=g, device=dev) * scale
    if C == 1:
        rows = rows[:, 0].contiguous()
    init = torch.randn((S,) + tuple(rows.shape[1:]), generator=g,
                       device=dev) * 1e3
    for ini in (None, init):
        out = cuda_scatter.segment_sum_ordered(rows, t, S, init=ini)
        ref = cuda_scatter.segment_sum_ordered_plain(
            rows.cpu(), t.cpu(), S, init=None if ini is None else ini.cpu())
        assert same_bits(out, ref)
        assert same_bits(out, cuda_scatter.segment_sum_ordered(
            rows, t.int(), S, init=ini))
