"""PyTorch port, the CUDA kernels on the card against their plain
versions.  Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; skips
elsewhere.  Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which a
PyTorch-only install need not have; this file imports only the port.)
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
    assert float((fk == fp).float().mean()) >= 0.9999
    assert float((jk == jp).float().mean()) >= 0.9999
    torch.testing.assert_close(d2k, d2p, rtol=0, atol=0)


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
    ref = cuda_scatter.windowed_scatter_plain(*args)
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


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
               cuda_gather.row_gather)
    before = [k.launches for k in kernels]
    m.shrink_wrap(pts, 3.0, max_iter=10, minimum_edge_length=4.0)
    assert all(k.launches > b for k, b in zip(kernels, before))
    r = np.linalg.norm(m.vertices, axis=1)
    assert abs(r.mean() - 50.0) < 1.5
    assert m.euler_characteristic == 2 and m.is_manifold
