"""The true shapes ``shape_gap`` holds the final surface to
(``reference/shapes/``): the sphere's module gives the bits of the
check's earlier radial gap, and the ERSim's signed distance is the
port's own, from a plain copy that imports nothing of the port."""

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.tests import bench_tiny


def radial_gap(vertices, centre, radius):
    """The check's sphere gap as it stood before the shape modules."""
    r = torch.sqrt(((vertices - centre) ** 2).sum(1))
    return float(torch.sqrt(((r - radius) ** 2).mean()))


ORIGIN = torch.tensor((0.0, 0.0, 0.0), dtype=torch.float64)
# the ERSim's solid lies in x -445..585, y -445..335, z -75..75 nm (its
# sdf < 0 on a 5 nm grid); the test box reaches 100 nm past that
ERSIM_BOX = ((-550.0, -550.0, -180.0), (690.0, 440.0, 180.0))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_sphere_equals_the_radial_gap_on_random_vertices(seed):
    sphere = harness.shape_module('sphere')
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((5000, 3), generator=g, dtype=torch.float64)
    v = v / v.norm(dim=1, keepdim=True) * 500.0 \
        + 3.0 * torch.randn((5000, 3), generator=g, dtype=torch.float64)
    assert sphere.gap(v, {'radius': 500.0}) == radial_gap(v, ORIGIN, 500.0)


def test_sphere_on_the_tiny_cells_final_surface(monkeypatch):
    """The tiny cell's final surface reads the same float through the
    sphere's module as through the old gap, and the run stays
    correct."""
    seen, orig = {}, check.compare

    def keep(state, final_mesh, *a, **k):
        seen['mesh'] = final_mesh
        return orig(state, final_mesh, *a, **k)
    monkeypatch.setattr(check, 'compare', keep)
    r = bench_tiny.run()
    assert r['correct'], r['compared']
    mesh = seen['mesh']
    faces = torch.from_numpy(np.asarray(mesh.faces, dtype=np.int64))
    verts = torch.from_numpy(np.asarray(mesh.vertices, dtype=np.float64))
    used = verts[torch.unique(faces.reshape(-1))]
    old = radial_gap(used, ORIGIN, bench_tiny.CONFIG['cloud']['radius'])
    assert r['compared']['shape_gap']['value'] == old


def _ersim():
    return harness.shape_module('ersim')


def test_ersim_sdf_agrees_with_the_port():
    from ch_shrinkwrap_torch.sim.shape import ERSim
    lo, hi = (np.array(b) for b in ERSIM_BOX)
    p = lo + (hi - lo) * np.random.default_rng(23).random((100_000, 3))
    want = torch.from_numpy(ERSim().sdf(p.T))
    got = _ersim().sdf(torch.from_numpy(p))
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


def _gradient(sdf, p, delta=1e-3):
    cols = []
    for k in range(3):
        h = torch.zeros(3, dtype=p.dtype)
        h[k] = delta / 2
        cols.append((sdf(p + h) - sdf(p - h)) / delta)
    return torch.stack(cols, 1)


def test_ersim_gap_on_the_ports_zero_level_surface():
    """Below 1 nm on the vertices of the port's own marching of the
    shape at 5 nm, and 10 nm within 10% once each vertex has moved
    10 nm out along the gradient."""
    from ch_shrinkwrap_torch.mesh.marching import surface_from_function
    from ch_shrinkwrap_torch.sim.shape import ERSim
    truth = ERSim()
    (x0, y0, z0), (x1, y1, z1) = ERSIM_BOX
    verts, faces = surface_from_function(lambda p: truth.sdf(p.T),
                                         (x0, y0, z0, x1, y1, z1), 5.0)
    used = torch.from_numpy(np.asarray(verts, np.float64)[np.unique(faces)])
    ersim = _ersim()
    assert used.shape[0] > 10_000
    assert ersim.gap(used, {}) < 1.0
    g = _gradient(ersim.sdf, used)
    moved = used + 10.0 * g / g.norm(dim=1, keepdim=True)
    assert ersim.gap(moved, {}) == pytest.approx(10.0, rel=0.1)
