"""PyTorch port, the host-only modules: the per-iteration animation and
the PYMEVis GUI hooks, held to the JAX package's."""

import logging
import os
import sys

import numpy as np
import pytest
import torch

from ch_shrinkwrap_tpu.animation import animate_shrinkwrap as janimate
from ch_shrinkwrap_tpu.mesh.primitives import icosphere
from ch_shrinkwrap_tpu.models.membrane_mesh import MembraneMesh as JMesh
from ch_shrinkwrap_tpu.visgui_modules import shrinkwrap as jgui_sw
from ch_shrinkwrap_tpu.visgui_modules import \
    surface_feature_extraction as jgui_sfe

from ch_shrinkwrap_torch.animation import animate_shrinkwrap
from ch_shrinkwrap_torch.models import MembraneMesh as TMesh
from ch_shrinkwrap_torch.visgui_modules import shrinkwrap as tgui_sw
from ch_shrinkwrap_torch.visgui_modules import \
    surface_feature_extraction as tgui_sfe

from torch_parity_native import load_both_engines

load_both_engines()
torch.set_num_threads(1)


def small_fit(cls, **kw):
    """tests/test_utils.py:13-22."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(800, 3))
    d /= np.linalg.norm(d, axis=1)[:, None]
    pts = (d * 50 + rng.normal(scale=3, size=(800, 3))).astype(np.float32)
    sigma = np.full((800, 3), 3.0, np.float32)
    v, f = icosphere(2, radius=60.0)
    mesh = cls(v, f, kc=1.0, step_size=4.0, remesh_frequency=0,
               delaunay_remesh_frequency=0, **kw)
    return mesh, pts, sigma


@pytest.fixture(scope='module')
def jax_frames(tmp_path_factory):
    mesh, pts, sigma = small_fit(JMesh)
    janimate(mesh, pts, sigma, str(tmp_path_factory.mktemp('jax')),
             max_iters=3)
    return mesh


@pytest.mark.parametrize('renderer', ['matplotlib', 'ply'])
def test_animation_frames_match_jax(renderer, jax_frames, tmp_path,
                                    monkeypatch):
    """3 frames (tests/test_utils.py:100-106): matplotlib renders, or
    PLY meshes when matplotlib does not import; the mesh after the same
    steps is the JAX package's within the solver's bounds
    (tests/test_solver.py:403-404)."""
    if renderer == 'ply':
        for name in list(sys.modules):
            if name == 'matplotlib' or name.startswith(('matplotlib.',
                                                        'mpl_toolkits')):
                monkeypatch.delitem(sys.modules, name)
        monkeypatch.setitem(sys.modules, 'matplotlib', None)
    mesh, pts, sigma = small_fit(TMesh, device='cpu')
    out = str(tmp_path / 'anim')
    animate_shrinkwrap(mesh, pts, sigma, out, max_iters=3)
    frames = sorted(os.listdir(out))
    ext = '.png' if renderer == 'matplotlib' else '.ply'
    assert frames == [f'frame{i:04d}{ext}' for i in range(3)]
    assert all(os.path.getsize(os.path.join(out, n)) > 0 for n in frames)
    jm = jax_frames
    assert mesh.faces.shape == jm.faces.shape
    assert np.abs(mesh.vertices - jm.vertices).max() < 0.5
    rt = np.linalg.norm(mesh.vertices, axis=1).mean()
    rj = np.linalg.norm(jm.vertices, axis=1).mean()
    assert abs(rt - rj) < 0.05
    assert mesh.remesh_frequency == 0 and mesh.delaunay_remesh_frequency == 0


def test_animation_curvature_histograms_match_jax(tmp_path):
    kw = dict(max_iters=2, return_curvature_mean_hists=True)
    tm, pts, sigma = small_fit(TMesh, device='cpu')
    ht, mt = animate_shrinkwrap(tm, pts, sigma, str(tmp_path / 't'), **kw)
    jm, _, _ = small_fit(JMesh)
    hj, mj = janimate(jm, pts, sigma, str(tmp_path / 'j'), **kw)
    assert ht.shape == hj.shape == (2, 99)
    np.testing.assert_allclose(mt, mj, atol=1e-5)


class StubVisFr:
    def __init__(self, pipeline=None):
        self.items = []
        self.pipeline = pipeline

    def AddMenuItem(self, menu, label, handler):
        self.items.append((menu, label))


def test_gui_hooks_register_the_jax_menu_items():
    for tmod, jmod in ((tgui_sw, jgui_sw), (tgui_sfe, jgui_sfe)):
        tv, jv = StubVisFr(), StubVisFr()
        tmod.Plug(tv)
        jmod.Plug(jv)
        assert tv.items == jv.items and tv.items


def test_gui_residuals_without_matplotlib(monkeypatch, caplog):
    """The residual handler runs on the port's fitted model and logs
    the histogram where matplotlib is absent."""
    mesh, pts, sigma = small_fit(TMesh, device='cpu')
    mesh.shrink_wrap(pts, sigma, max_iter=2)

    class Pipeline:
        dataSources = {'membrane0': mesh}

    monkeypatch.setattr(tgui_sw, 'last_membrane', 'membrane0')
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    with caplog.at_level(logging.INFO, logger=tgui_sw.__name__):
        tgui_sw.show_residuals(StubVisFr(Pipeline()))
    assert 'residual histogram' in caplog.text
