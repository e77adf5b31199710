"""PyTorch port, the brute-force search's plain version (what
``cuda_brute.brute_min`` runs on CPU tensors, and what the kernel in
``csrc/brute.cu`` is held to on the card).

The kernel splits the faces over blocks and merges their minima in any
order, so it relies on the plain version's result not depending on how
the faces and points are cut: the same bits for every ``face_chunk`` and
``point_block``, ties to the lowest face id, and the ``(BIG, 0)``
sentinel where no face is valid.  Its agreement with the JAX package is
``test_torch_correspondence.py::test_bruteforce_matches_jax``.
"""

import numpy as np
import pytest
import torch

from ch_shrinkwrap_torch.ops import correspondence as corr
from ch_shrinkwrap_torch.ops import cuda_brute

torch.set_num_threads(1)


def _case(n_points=700, n_faces=900, seed=0):
    """A noisy sphere cloud against face centres on the same sphere,
    with every face centre of the first third repeated in the last
    third (ties across chunks) and masked rows interleaved and at the
    end."""
    rng = np.random.default_rng(seed)

    def sphere(n, sigma):
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1)[:, None]
        return d * 50.0 + rng.normal(scale=sigma, size=(n, 3))

    pts = sphere(n_points, 3.0).astype(np.float32)
    cen = sphere(n_faces, 0.5).astype(np.float32)
    third = n_faces // 3
    cen[n_faces - third:] = cen[:third]
    mask = np.ones(n_faces, bool)
    mask[5::7] = False
    mask[-40:] = False
    return torch.from_numpy(pts), torch.from_numpy(cen), \
        torch.from_numpy(mask)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize('face_chunk,point_block', [
    (1, 700), (7, 64), (128, 1), (300, 333), (899, 1000), (900, 699),
    (4096, 7)])
def test_plain_bits_do_not_depend_on_the_chunks(face_chunk, point_block):
    pts, cen, mask = _case()
    d0, i0 = cuda_brute.brute_min_plain(pts, cen, mask)
    d, i = cuda_brute.brute_min_plain(pts, cen, mask, face_chunk=face_chunk,
                                      point_block=point_block)
    assert torch.equal(i, i0)
    assert torch.equal(_bits(d), _bits(d0))


def test_plain_ties_go_to_the_lowest_id():
    """Every face of the first third has a twin in the last third: no
    point is matched to a twin, and no point to a masked face."""
    pts, cen, mask = _case()
    _, i = cuda_brute.brute_min_plain(pts, cen, mask, face_chunk=100)
    n = cen.shape[0]
    third = n // 3
    twin_of_valid = torch.zeros(n, dtype=torch.bool)
    twin_of_valid[n - third:] = mask[:third]
    assert not twin_of_valid[i.long()].any()
    assert mask[i.long()].all()


@pytest.mark.parametrize('n_faces', [0, 1, 900])
def test_plain_with_no_valid_face_returns_the_sentinel(n_faces):
    pts, cen, _ = _case(n_faces=max(n_faces, 3))
    cen = cen[:n_faces]
    mask = torch.zeros(n_faces, dtype=torch.bool)
    d, i = cuda_brute.brute_min_plain(pts, cen, mask, face_chunk=256)
    big = torch.tensor(corr.BIG, dtype=torch.float32)
    assert torch.equal(i, torch.zeros_like(i))
    assert torch.equal(d, torch.sqrt(big).expand_as(d))


def test_bruteforce_on_the_cpu_launches_no_kernel():
    pts, cen, mask = _case(n_points=200, n_faces=300)
    n0 = cuda_brute.brute_min.launches
    d, i = corr.nearest_face_bruteforce(pts, cen, mask)
    d2, i2 = corr.nearest_face(pts, cen, mask)
    assert cuda_brute.brute_min.launches == n0
    d3, i3 = cuda_brute.brute_min_plain(pts, cen, mask)
    assert torch.equal(i, i3) and torch.equal(i2, i3)
    assert torch.equal(_bits(d), _bits(d3)) and torch.equal(_bits(d2),
                                                            _bits(d3))


@pytest.mark.parametrize('where', ['centers', 'f_mask'])
def test_mixed_devices_raise(where):
    pts, cen, mask = _case(n_points=10, n_faces=12)
    args = dict(points=pts, centers=cen, f_mask=mask)
    args[where] = args[where].to('meta')
    for fn in (cuda_brute.brute_min, cuda_brute.brute_min_plain):
        with pytest.raises(ValueError, match='one device'):
            fn(**args)


@pytest.mark.parametrize('shape', ['points', 'centers', 'f_mask'])
def test_bad_shapes_raise(shape):
    pts, cen, mask = _case(n_points=10, n_faces=12)
    args = dict(points=pts, centers=cen, f_mask=mask)
    args[shape] = args[shape][..., :2] if shape != 'f_mask' \
        else args[shape][:-1]
    with pytest.raises(ValueError):
        cuda_brute.brute_min(**args)


def test_search_route():
    assert corr.search_route('brute', 'cuda') == 'kernel'
    assert corr.search_route('windowed', torch.device('cuda', 0)) == 'kernel'
    for method in ('grid', 'blocked'):
        assert corr.search_route(method, 'cuda') == 'plain'
    for method in ('brute', 'windowed', 'grid'):
        assert corr.search_route(method, 'cpu') == 'plain'
