"""PyTorch port, K2's plain version (windowed A^T scatter) held to the
JAX package's Pallas scatter in interpret mode, all four modes, at the
JAX suite's shapes (tests/test_solver.py:310-381), to 1e-4 * max|ref|.

K2's kernel (``csrc/scatter.cu``) runs only on a CUDA card; on CPU
tensors ``windowed_scatter`` runs its plain version.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.ops import meshdata as jmd
from ch_shrinkwrap_tpu.ops import correspondence as jcorr
from ch_shrinkwrap_tpu.ops import pallas_scatter as jps

from ch_shrinkwrap_torch.ops import correspondence as tcorr
from ch_shrinkwrap_torch.ops import cuda_scatter

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)

W = 1024


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def routing():
    """Real routing data: the JAX windowed search (interpret) on a noisy
    sphere cloud with background, so rows win both through windows and
    through the subsample."""
    rng = np.random.default_rng(5)
    v, f = icosphere(4, radius=50.0)
    ma = jmd.from_mesh(TriangleMesh(v, f), quantum=256)
    centers = np.asarray(ma.positions)[np.asarray(ma.faces)].mean(1)
    d = rng.normal(size=(6000, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = d * 50.0 + rng.normal(scale=3.0, size=d.shape)
    far = rng.uniform(-150, 150, (400, 3))
    allp = np.vstack([pts, far]).astype(np.float32)
    allp = allp[jcorr.fit_point_order(allp)]
    _, fid, meta = jcorr.nearest_face_windowed(
        jnp.asarray(allp), jnp.asarray(centers), ma.f_mask, window=W,
        use_pallas=True, pallas_interpret=True, return_meta=True)
    N = allp.shape[0]
    w = rng.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
    res = rng.normal(size=(N, 3)).astype(np.float32)
    vals = rng.normal(size=(N, 12)).astype(np.float32)
    return dict(ma=ma, pts=allp, centers=centers.astype(np.float32),
                fid=np.asarray(fid), js=np.asarray(meta.js),
                starts=np.asarray(meta.starts),
                sub_ids=np.asarray(meta.sub_ids), w=w, res=res, vals=vals,
                Fp=centers.shape[0])


def _jax_ahw2(r, fid):
    """JAX reference of the 18 AH+W2 columns (interpret mode).  The JAX
    suite holds this fused sweep bit-exact to its separate 'ah' and
    'w2' wrappers (test_windowed_ahw2_fused_matches_separate_passes),
    so one compile serves all three modes."""
    a, b = jps.windowed_ahw2_pallas(
        jnp.asarray(r['w']), jnp.asarray(r['res']), jnp.asarray(fid),
        jnp.asarray(r['js']), jnp.asarray(r['starts']),
        jnp.asarray(r['sub_ids']), num_segments=r['Fp'], window=W,
        interpret=True)
    return np.concatenate([np.asarray(a), np.asarray(b)], axis=1)


@pytest.fixture(scope='module')
def jax_refs(routing):
    r = routing
    given = jps.windowed_segment_sum_pallas(
        jnp.asarray(r['vals']), jnp.asarray(r['fid']),
        jnp.asarray(r['js']), jnp.asarray(r['starts']),
        jnp.asarray(r['sub_ids']), num_segments=r['Fp'], window=W,
        interpret=True)
    return {'ahw2': _jax_ahw2(r, r['fid']), 'given': np.asarray(given)}


def _port(mode, r, fid, row_strides=None):
    """The mode's public wrapper on the routing data; its outputs' row
    strides are appended to ``row_strides`` when given."""
    kw = dict(num_segments=r['Fp'], window=W)
    args = (t(fid), t(r['js']), t(r['starts']), t(r['sub_ids']))
    if mode == 'ah':
        outs = [cuda_scatter.windowed_ah(t(r['w']), t(r['res']), *args,
                                         **kw)]
    elif mode == 'ahw2':
        outs = list(cuda_scatter.windowed_ahw2(t(r['w']), t(r['res']),
                                               *args, **kw))
    elif mode == 'w2':
        outs = [cuda_scatter.windowed_w2(t(r['w']), *args, **kw)]
    else:
        outs = [cuda_scatter.windowed_segment_sum_cuda(t(r['vals']), *args,
                                                       **kw)]
    if row_strides is not None:
        row_strides += [o.stride() for o in outs]
    return torch.cat(outs, 1)


_REF_COLS = {'ah': ('ahw2', slice(0, 12)), 'ahw2': ('ahw2', slice(0, 18)),
             'w2': ('ahw2', slice(12, 18)), 'given': ('given', slice(0, 12))}


@pytest.mark.parametrize('mode', ['ah', 'ahw2', 'w2', 'given'])
def test_windowed_scatter_plain_matches_pallas_interpret(routing, jax_refs,
                                                         mode):
    key, cols = _REF_COLS[mode]
    ref = jax_refs[key][:, cols]
    strides = []
    out = _port(mode, routing, routing['fid'], strides)
    assert out.shape == ref.shape
    # the output table's rows are padded to a multiple of 4 columns (the
    # kernel writes them with 16-byte stores); callers get column views
    C4 = {'ah': 12, 'ahw2': 20, 'w2': 8, 'given': 12}[mode]
    assert strides == [(C4, 1)] * (2 if mode == 'ahw2' else 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert cuda_scatter.windowed_scatter.launches == 0   # CPU -> plain


def test_polished_fid_outside_windows_routes_to_subsample(routing):
    """After the adjacency polish (plus a few random faces) some fids
    lie in no window of their block: the row must land on
    sub_ids[js], as the TPU kernel routes it — not on fid."""
    r = routing
    ma = r['ma']
    _, fid = jcorr.refine_correspondence(
        jnp.asarray(r['pts']), jnp.asarray(r['centers']), ma.face_nbrs,
        jnp.asarray(r['fid']), n_iter=2)
    fid = np.asarray(fid).copy()
    rng = np.random.default_rng(3)
    pick = rng.random(fid.shape[0]) < 0.02
    fid[pick] = rng.integers(0, int(np.asarray(ma.f_mask).sum()),
                             int(pick.sum()))
    tgt = cuda_scatter.route(t(fid), t(r['js']), t(r['starts']),
                             t(r['sub_ids']), W, 256, False).numpy()
    outside = tgt != fid
    assert outside.sum() > 20
    np.testing.assert_array_equal(tgt[outside],
                                  r['sub_ids'][r['js'][outside]])

    ref = _jax_ahw2(r, fid)[:, :12]
    out = _port('ah', r, fid)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    # the same rows summed by fid instead differ
    rows = cuda_scatter._columns('ah', t(r['w']), t(r['res']), None)
    by_fid = torch.zeros_like(out).index_add_(0, t(fid).long(), rows)
    assert np.abs(by_fid.numpy() - ref).max() > 1e-2 * np.abs(ref).max()


def test_discard_sub_drops_unrouted_rows(routing):
    """discard_sub: rows whose face lies in no window are dropped."""
    r = routing
    args = (t(r['fid']), t(r['js']), t(r['starts']), t(r['sub_ids']))
    out = cuda_scatter.windowed_segment_sum_cuda(
        t(r['vals']), *args, num_segments=r['Fp'], window=W,
        discard_sub=True).numpy()
    blk = np.arange(r['fid'].shape[0]) // 256
    off = r['fid'][:, None] - r['starts'][blk]
    in_win = ((off >= 0) & (off < W)).any(1)
    assert (~in_win).sum() > 0
    ref = np.zeros_like(out)
    np.add.at(ref, r['fid'][in_win], r['vals'][in_win])
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_windowed_segment_sum_matches_jax(routing):
    """The plain windowed segment-sum (any column count) against the
    JAX package's XLA formulation and an exact segment_sum."""
    r = routing
    meta_j = jcorr.WindowedMeta(starts=jnp.asarray(r['starts']),
                                js=jnp.asarray(r['js']),
                                sub_ids=jnp.asarray(r['sub_ids']))
    ref = jax.jit(lambda v_, f_: jcorr.windowed_segment_sum(
        v_, f_, meta_j, r['Fp'], window=W))(jnp.asarray(r['vals']),
                                            jnp.asarray(r['fid']))
    meta_t = tcorr.WindowedMeta(starts=t(r['starts']), js=t(r['js']),
                                sub_ids=t(r['sub_ids']))
    out = tcorr.windowed_segment_sum(t(r['vals']), t(r['fid']), meta_t,
                                     r['Fp'], window=W)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    exact = jax.ops.segment_sum(jnp.asarray(r['vals']),
                                jnp.asarray(r['fid']),
                                num_segments=r['Fp'])
    np.testing.assert_allclose(out.numpy(), np.asarray(exact), rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_scatter_rejects_bad_input(routing):
    r = routing
    args = (t(r['fid']), t(r['js']), t(r['starts']), t(r['sub_ids']))
    with pytest.raises(ValueError):
        cuda_scatter.windowed_segment_sum_cuda(
            torch.zeros((r['fid'].shape[0], 13)), *args,
            num_segments=r['Fp'])
    with pytest.raises(ValueError):
        cuda_scatter.windowed_ah(t(r['w'][:, :2]), t(r['res']), *args,
                                 num_segments=r['Fp'])
