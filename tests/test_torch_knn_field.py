"""PyTorch port, the seed's density field: ``ops.cuda_field`` against the
host engine (``native.knn_field``), bit for bit.

The unmarked cases hold the plain version (the CPU reference of the
kernel) to the JAX package's engine (``ch_shrinkwrap_tpu.native.
knn_field``) and the port's on small clouds, the kernel's card path to
the port's own ordering, ``wrap_start``'s host route, and the counters of
its ``field`` span.  The cases marked ``cuda`` hold the kernel to the
port's engine on the card, at the benchmark's sizes too; they skip
without a card.  The JAX package is absent there, so the port's engine
is their reference, and the unmarked cases hold it to the JAX package's
on the same edge cases.  Run them there from the repository's root with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_knn_field.py

(at import this file loads only the port and the benchmark's cloud
generator; the JAX package is loaded by the unmarked cases' fixture).
"""

import ast
import inspect

import numpy as np
import pytest
import torch

from ch_shrinkwrap_torch import native
from ch_shrinkwrap_torch.mesh.marching import grid_nodes, seed_grid, \
    wrap_start
from ch_shrinkwrap_torch.ops import cuda_field


def sphere(n, radius, sigma, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    return (d * radius + rng.normal(scale=sigma, size=(n, 3))
            ).astype(np.float32)


def seed_queries(pts, offset, grid_n):
    """wrap_start's marching nodes (float32, as both engines take them)
    and its field bound."""
    bbox, step, bound = seed_grid(pts, offset, grid_n)
    return grid_nodes(bbox, step)[1].astype(np.float32), bound


def lattice_shell(r0, r1, spacing):
    """The nodes of a cubic lattice in the shell r0 <= |x| < r1: many
    exactly tied distances."""
    a = np.arange(-r1, r1 + spacing, spacing)
    X = np.stack(np.meshgrid(a, a, a, indexing='ij'), -1).reshape(-1, 3)
    r = np.linalg.norm(X, axis=1)
    return X[(r >= r0) & (r < r1)].astype(np.float32)


def case(name):
    """(points, queries, k, bound) of a named field case."""
    rng = np.random.default_rng(22)
    if name == 'sphere':
        pts = sphere(3000, 60.0, 3.0, 1)
        q, bound = seed_queries(pts, 8.0, 16)
        return pts, q, 50, bound
    if name == 'lattice_ties':
        pts = lattice_shell(20.0, 26.0, 2.0)
        q, bound = seed_queries(pts, 6.0, 12)
        # queries on lattice nodes and on the centres of lattice cells:
        # the distances around them tie in whole shells
        on = pts[rng.choice(len(pts), 300, replace=False)]
        return pts, np.concatenate([q, on, on + 1.0]), 50, bound
    if name == 'k1':
        pts = sphere(3000, 60.0, 3.0, 2)
        q, bound = seed_queries(pts, 8.0, 16)
        return pts, q, 1, bound
    if name == 'fewer_than_k':
        pts = sphere(30, 60.0, 3.0, 3)
        q, bound = seed_queries(pts, 8.0, 10)
        return pts, q, 50, bound
    if name == 'outside_the_box':
        pts = sphere(2000, 40.0, 2.0, 4)
        q = np.concatenate([
            rng.uniform(-1e4, 1e4, (200, 3)),
            rng.uniform(-60.0, 60.0, (600, 3)),
            np.array([[1e30, 0, 0], [-1e30, 1e30, 0], [0, 0, -3e38]])])
        return pts, q.astype(np.float32), 5, 15.0
    if name == 'one_cell':
        # the bound exceeds the cloud: one cell holds it all, and more
        # points lie within than a warp keeps in shared memory
        pts = sphere(3000, 30.0, 2.0, 5)
        q = np.concatenate([rng.uniform(-80.0, 80.0, (400, 3)),
                            rng.uniform(560.0, 600.0, (20, 3))])
        return pts, q.astype(np.float32), 50, 500.0
    if name == 'k_past_the_kept':
        pts = rng.normal(scale=2.0, size=(2600, 3)).astype(np.float32)
        q = np.concatenate([rng.normal(scale=4.0, size=(300, 3)),
                            rng.uniform(30.0, 60.0, (20, 3))])
        return pts, q.astype(np.float32), 2100, 40.0
    if name == 'bound_below_nearest':
        pts = lattice_shell(0.0, 40.0, 10.0)
        q = (pts[:200] + np.float32(3.0)).astype(np.float32)
        return pts, q, 1, 2.5
    raise KeyError(name)


CASES = ['sphere', 'lattice_ties', 'k1', 'fewer_than_k', 'outside_the_box',
         'one_cell', 'k_past_the_kept', 'bound_below_nearest']


def bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


# ---- the plain version (CPU) ----------------------------------------------

@pytest.fixture(scope='module')
def jax_native():
    """The JAX package's host engine, loaded from a private build (see
    ``torch_parity_native``); imported here, not at module import, so
    the card cases run without the JAX package."""
    from torch_parity_native import load_both_engines
    load_both_engines()
    from ch_shrinkwrap_tpu import native as jnative
    return jnative


@pytest.mark.parametrize('name', CASES)
def test_plain_equals_host_engine(name, jax_native):
    """The field on CPU tensors (the plain version) equals the JAX
    package's host engine bit for bit, and so does the port's engine
    (the card cases' reference); every query the rejection stops is a
    miss there too."""
    pts, q, k, bound = case(name)
    ref = jax_native.knn_field(pts, q, k, bound)
    assert np.array_equal(bits(native.knn_field(pts, q, k, bound)),
                          bits(ref))
    live = torch.empty(len(q), dtype=torch.bool)
    got = cuda_field.knn_field(torch.from_numpy(pts), torch.from_numpy(q),
                               k, bound, live=live).numpy()
    assert np.array_equal(bits(got), bits(ref))
    miss = ref == 2 * np.float32(bound)
    assert miss[~live.numpy()].all()
    if name == 'bound_below_nearest':
        assert miss.all()
    elif name == 'fewer_than_k':
        assert miss.all() and not live.any()
    else:
        assert (~miss).any() and miss.any()


@pytest.mark.parametrize('extent,bound', [(1040.0, 67.57), (1.0, 500.0),
                                          (1e5, 1e-3), (0.0, 2.0)])
def test_field_grid_covers_the_ball(extent, bound):
    """The grid stays within MAX_CELLS, and the cube of ``nblock`` cells
    each way reaches past the bound by at least two margins."""
    lo = np.full(3, -extent / 2, np.float32)
    g = cuda_field.field_grid(lo, -lo, bound)
    assert np.prod(g.dims) <= cuda_field.MAX_CELLS
    assert all(d >= 1 for d in g.dims)
    assert g.nblock * g.c >= bound + 2 * g.margin
    assert g.margin >= g.c / 64


def test_card_path_calls_no_library_ordering():
    """The card path bins with the port's radix ordering and calls no
    library sort, selection or search."""
    tree = ast.parse(inspect.getsource(cuda_field.knn_field))
    calls = {n.func.attr if isinstance(n.func, ast.Attribute) else
             getattr(n.func, 'id', None)
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert 'radix_order' in calls
    assert not calls & {'sort', 'argsort', 'searchsorted', 'unique',
                        'unique_consecutive', 'msort', 'topk', 'kthvalue',
                        'segment_order', 'bincount'}


# ---- wrap_start's route and the field span --------------------------------

def field_records(mesh):
    return [r for r in mesh.trace.records if r.kind == 'seed/march/field']


@pytest.mark.parametrize('how', ['device_cpu', 'no_cuda'])
def test_host_route(how, monkeypatch):
    """``device='cpu'``, and no card at all, take the host engine."""
    pts = sphere(2000, 50.0, 2.0, 6)
    if how == 'no_cuda':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        mesh = wrap_start(pts, offset=8.0, grid_n=10)
    else:
        mesh = wrap_start(pts, offset=8.0, grid_n=10, device='cpu')
    (rec,) = field_records(mesh)
    assert rec.extra['route'] == 'host'


@pytest.mark.parametrize('seed,offset', [(7, 8.0), (8, 4.0)])
def test_field_span_counters(seed, offset):
    """The host route's span extras are present and right: every query
    is counted, the misses are the engine's, and ``live`` (which only
    the kernel reports) is None."""
    pts = sphere(2000, 50.0, 2.0, seed)
    mesh = wrap_start(pts, offset=offset, grid_n=10, device='cpu')
    (rec,) = field_records(mesh)
    x = rec.extra
    q, bound = seed_queries(pts, offset, 10)
    assert set(x) == {'route', 'queries', 'live', 'misses'}
    assert x['route'] == 'host' and x['live'] is None
    assert x['queries'] == len(q)
    assert 0 < x['misses'] < x['queries']
    assert x['misses'] == int(
        (native.knn_field(pts, q, 50, bound) == 2 * np.float32(bound)).sum())


# ---- the kernel on the card ------------------------------------------------

@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def on_card(dev, pts, q, k, bound):
    live = torch.empty(len(q), dtype=torch.bool, device=dev)
    out = cuda_field.knn_field(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(q).to(dev), k, bound,
                               live=live)
    torch.cuda.synchronize()
    return out.cpu().numpy(), live.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize('name', CASES)
def test_kernel_equals_host_engine(dev, name):
    """The kernel equals the host engine bit for bit, and reports the
    plain version's live queries."""
    pts, q, k, bound = case(name)
    got, live = on_card(dev, pts, q, k, bound)
    assert np.array_equal(bits(got), bits(native.knn_field(pts, q, k, bound)))
    assert torch.equal(live, cuda_field.reaches_search(
        torch.from_numpy(pts), torch.from_numpy(q), k, bound))


def benchmark_cloud(name):
    from benchmark.cloud import sphere_cloud
    pts, _ = sphere_cloud(1_000_000, 500.0, 5.0, 2_718_281_828)
    if name == 'image_lattice':
        from benchmark.fits.image import histogram, pseudo_localizations
        rows, _ = pseudo_localizations(histogram(pts, 5.0))
        pts = rows.astype(np.float32)
    return pts


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['sphere_1m', 'image_lattice'])
def test_kernel_on_benchmark_clouds(dev, name):
    """At the cells' own sizes: the 1e6-point sphere and the image
    cell's voxel lattice (exact ties), at wrap_start(offset=25,
    grid_n=48)'s queries (49^3 and 50^3: np.arange's count follows the
    box), k = 50."""
    pts = benchmark_cloud(name)
    if name == 'image_lattice':
        assert len(pts) > 400_000
    q, bound = seed_queries(pts, 25.0, 48)
    assert len(q) >= 49 ** 3
    got, live = on_card(dev, pts, q, 50, bound)
    ref = native.knn_field(pts, q, 50, bound)
    assert np.array_equal(bits(got), bits(ref))
    assert torch.equal(live, cuda_field.reaches_search(
        torch.from_numpy(pts), torch.from_numpy(q), 50, bound))


@pytest.mark.cuda
def test_wrap_start_card_equals_host(dev):
    """The seed on the card is the host route's mesh, at 1e6 points."""
    pts = benchmark_cloud('sphere_1m')
    card = wrap_start(pts, offset=25.0, grid_n=48)
    host = wrap_start(pts, offset=25.0, grid_n=48, device='cpu')
    (rec,) = field_records(card)
    (hrec,) = field_records(host)
    x = rec.extra
    assert x['route'] == 'card' and hrec.extra['route'] == 'host'
    for key in ('queries', 'misses'):
        assert x[key] == hrec.extra[key]
    assert 0 < x['live'] <= x['queries']
    assert x['misses'] >= x['queries'] - x['live']
    assert np.array_equal(card.vertices, host.vertices)
    assert np.array_equal(card.faces, host.faces)
