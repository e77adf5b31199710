"""PyTorch port, K3's plain versions (row gather, and the fold's fused
gather + masked group sum) and the index streams the fit feeds them,
held to the JAX package.

The JAX suite checks its sliding-ring gather against a plain
``src[idx]`` (tests/test_ring_gather.py:22); K3 reads the index stream
directly, so its plain version must equal ``src[idx]`` bit for bit.  The
fold is held to the JAX package's ``segment_sum`` fold within the
accumulation bound 1e-4 * max|ref|.  K3's kernels (``csrc/gather.cu``)
run only on a CUDA card.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JMesh
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.ops import meshdata as jmd

from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TMesh
from ch_shrinkwrap_torch.ops import meshdata as tmd
from ch_shrinkwrap_torch.ops import cuda_gather
from ch_shrinkwrap_torch.solver.shrinkwrap import _fold

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


@pytest.mark.parametrize('C', [1, 3, 6, 7, 9, 16])
def test_row_gather_plain_is_exact(C):
    rng = np.random.default_rng(C)
    V, R = 3000, 20_000
    src = rng.normal(size=(V, C)).astype(np.float32)
    idx = rng.integers(0, V, R).astype(np.int32)
    ref = np.asarray(jnp.asarray(src)[jnp.asarray(idx)])
    out = cuda_gather.row_gather(torch.from_numpy(src),
                                 torch.from_numpy(idx))
    assert out.dtype == torch.float32 and out.shape == (R, C)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert cuda_gather.row_gather.launches == 0        # CPU -> plain


def test_row_gather_out_of_range_rows_are_zero():
    src = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([0, -1, 3, 4, 2], dtype=torch.int32)
    out = cuda_gather.row_gather(src, idx)
    np.testing.assert_array_equal(
        out.numpy(), [[0, 1, 2], [0, 0, 0], [9, 10, 11], [0, 0, 0],
                      [6, 7, 8]])


def test_row_gather_rejects_bad_input():
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_gather.row_gather(torch.zeros((4, 17)), idx)
    with pytest.raises(TypeError):
        cuda_gather.row_gather(torch.zeros((4, 3), dtype=torch.float64),
                               idx)
    with pytest.raises(ValueError):
        cuda_gather.row_gather(torch.zeros((4, 3)), idx.reshape(2, 2))


def test_row_group_sum_plain_semantics():
    """out[v] = sum_k care[v, k] * src[idx[v K + k]], summed over k in
    order; masked slots and indices outside [0, V) add nothing."""
    rng = np.random.default_rng(3)
    V, R, K, C = 50, 40, 8, 7
    src = rng.normal(size=(V, C)).astype(np.float32)
    idx = rng.integers(-3, V + 3, R * K).astype(np.int32)
    care = rng.random((R, K)) < 0.7
    out = cuda_gather.row_group_sum(torch.from_numpy(src),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(care)).numpy()
    ref = np.zeros((R, C), np.float32)
    ii = idx.reshape(R, K)
    for k in range(K):
        ok = care[:, k] & (ii[:, k] >= 0) & (ii[:, k] < V)
        ref[ok] += src[ii[ok, k]]
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):       # care must be bool (R, K)
        cuda_gather.row_group_sum(torch.from_numpy(src),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(care).float())
    with pytest.raises(ValueError):       # idx and care disagree
        cuda_gather.row_group_sum(torch.from_numpy(src),
                                  torch.from_numpy(idx[:-1]),
                                  torch.from_numpy(care))
    with pytest.raises(ValueError):       # at most 16 rows a group
        cuda_gather.row_group_sum(
            torch.from_numpy(src), torch.zeros(R * 17, dtype=torch.int32),
            torch.ones((R, 17), dtype=torch.bool))


@pytest.fixture(scope='module')
def padded():
    rng = np.random.default_rng(1)
    v, f = icosphere(4, radius=50.0)
    v = (v + rng.normal(scale=0.3, size=v.shape)).astype(np.float32)
    ja = jmd.from_mesh(JMesh(v, f), quantum=256)
    ta = tmd.from_mesh(TMesh(v, f), quantum=256, device='cpu')
    return ja, ta


def test_gather_tables_match_jax_tables(padded):
    """The streams the fit's gathers read: faces for tri/S, the k-major
    one-ring stream for the curvature prior, the incidence table for
    the fold — each derived from the JAX package's own tables."""
    ja, ta = padded
    g = tmd.gather_tables(ta)
    faces = np.asarray(ja.faces)
    np.testing.assert_array_equal(g.tri_idx.numpy(), faces.reshape(-1))
    nbr = np.asarray(ja.nbr_v)
    Vp, Kn = nbr.shape[0], tmd.NCC_K
    np.testing.assert_array_equal(
        g.ncc_idx.numpy().reshape(Kn, Vp),
        np.clip(nbr[:, :Kn], 0, None).T)
    np.testing.assert_array_equal(g.ncc_care.numpy(), (nbr[:, :Kn] >= 0).T)
    inc, ov_r, ov_v = jmd.incidence_table(faces, np.asarray(ja.f_mask),
                                          Vp)
    np.testing.assert_array_equal(g.fold_idx.numpy().reshape(Vp, -1),
                                  np.clip(inc, 0, None))
    np.testing.assert_array_equal(g.fold_care.numpy(), inc >= 0)
    if len(ov_r):
        np.testing.assert_array_equal(g.fold_ov[0].numpy(), ov_r)
        np.testing.assert_array_equal(g.fold_ov[1].numpy(), ov_v)
    else:
        assert g.fold_ov is None


@pytest.mark.parametrize('valence_cap', [8, 5])
def test_fold_by_gather_matches_segment_sum(padded, valence_cap):
    """faces -> vertices fold as K3 gather of incident rows + masked sum
    (+ overflow rows when valence exceeds the table width) equals the
    JAX segment_sum fold."""
    import jax
    ja, ta = padded
    g = tmd.gather_tables(ta)
    if valence_cap != tmd.FOLD_K:
        inc, ov_r, ov_v = tmd.incidence_table(ta.host['faces'],
                                              ta.host['f_mask'],
                                              ta.positions.shape[0],
                                              K=valence_cap)
        assert len(ov_r) > 0
        g = g._replace(
            fold_idx=torch.from_numpy(np.clip(inc, 0, None).reshape(-1)),
            fold_care=torch.from_numpy(inc >= 0),
            fold_ov=(torch.from_numpy(ov_r).long(),
                     torch.from_numpy(ov_v).long()))
    Fp, Vp = ja.faces.shape[0], ja.positions.shape[0]
    rng = np.random.default_rng(2)
    fused = rng.normal(size=(3 * Fp, 7)).astype(np.float32)
    fused *= np.repeat(np.asarray(ja.f_mask), 3)[:, None]
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(fused),
                                         ja.faces.reshape(-1),
                                         num_segments=Vp))
    out = _fold(torch.from_numpy(fused), ta.faces, Vp, g).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    # the fused group sum alone, plus the overflow rows, is the fold
    # (K3f's plain version; the fit's tolerance, 1e-4 * max|ref|)
    gs = cuda_gather.row_group_sum_plain(torch.from_numpy(fused),
                                         g.fold_idx, g.fold_care)
    assert cuda_gather.row_group_sum.launches == 0
    if g.fold_ov is not None:
        gs = gs.index_add(0, g.fold_ov[1],
                          torch.from_numpy(fused)[g.fold_ov[0]])
    np.testing.assert_allclose(gs.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    plain = _fold(torch.from_numpy(fused), ta.faces, Vp, None).numpy()
    np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=1e-5)
