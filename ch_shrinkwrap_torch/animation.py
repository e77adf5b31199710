"""Per-iteration fit animation.

Counterpart of the JAX package's ``animation.py``: step the port's fit
one iteration at a time and save a frame after each.  With a PYMEVis
(layer, pymevis) pair the frames are GL captures; otherwise matplotlib
renders them, or, where matplotlib does not import, each frame is the
mesh as a PLY file.  Optionally tracks the mean-curvature histogram.
"""

from __future__ import annotations

import os

import numpy as np


def _render_frame_matplotlib(mesh, path, elev=20, azim=-60):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection='3d')
    tri = mesh.vertices[mesh.faces]
    pc = Poly3DCollection(tri, alpha=0.8, facecolor='#7fa8d0',
                          edgecolor='none')
    ax.add_collection3d(pc)
    lo = mesh.vertices.min(0)
    hi = mesh.vertices.max(0)
    c = 0.5 * (lo + hi)
    r = 0.55 * float((hi - lo).max())
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.savefig(path, dpi=100, bbox_inches='tight')
    plt.close(fig)


def animate_shrinkwrap(mesh, pts, sigma, save_dir, layer=None,
                       pymevis=None, return_curvature_mean_hists=False,
                       frame_format='png', max_iters=None):
    """Step the fit of ``mesh`` (a port ``MembraneMesh``) one iteration
    per frame, saving ``frame%04d`` files in ``save_dir``: GL captures
    with a PYMEVis (layer, pymevis) pair, else matplotlib renders, else
    PLY meshes.  Returns (histograms, means) of the mean curvature with
    ``return_curvature_mean_hists``."""
    if max_iters is None:
        max_iters = mesh.max_iter
    saved = dict(dr=mesh.delaunay_remesh_frequency,
                 r=mesh.remesh_frequency)
    mesh.delaunay_remesh_frequency = 0
    remesh_frequency = saved['r']
    mesh.remesh_frequency = 0

    os.makedirs(save_dir, exist_ok=True)

    hists, means, edges = None, None, None
    if return_curvature_mean_hists:
        edges = np.linspace(-0.02, 0.02, 100)
        hists = np.zeros((max_iters, len(edges) - 1))
        means = np.zeros(max_iters)
        hists[0, :], _ = np.histogram(mesh.curvature_mean, bins=edges,
                                      density=True)

    def capture(i):
        path = os.path.join(save_dir,
                            'frame{:04d}.{}'.format(i, frame_format))
        if layer is not None and pymevis is not None:
            from PIL import Image
            layer.update()
            snap = pymevis.glCanvas.getIm().transpose(1, 0, 2)
            Image.fromarray(snap).transpose(
                Image.FLIP_TOP_BOTTOM).save(path)
            return
        try:
            _render_frame_matplotlib(mesh, path)
        except ImportError:
            mesh.to_ply(os.path.join(save_dir,
                                     'frame{:04d}.ply'.format(i)))

    capture(0)
    for i in range(1, max_iters):
        mesh.shrink_wrap(pts, sigma, max_iter=1)
        if remesh_frequency and (i % remesh_frequency) == 0:
            mesh.remesh(5, -1.0, 0.5, 0)
        if return_curvature_mean_hists:
            hists[i, :], _ = np.histogram(mesh.curvature_mean,
                                          bins=edges, density=True)
            means[i] = float(np.mean(mesh.curvature_mean))
        capture(i)

    mesh.delaunay_remesh_frequency = saved['dr']
    mesh.remesh_frequency = saved['r']
    if return_curvature_mean_hists:
        return hists, means
