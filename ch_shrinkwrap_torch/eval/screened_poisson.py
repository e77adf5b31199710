"""Screened Poisson reconstruction wrapper (competitor baseline).

Parity with the reference ch_shrinkwrap/screened_poisson.py:13-135 —
wraps pymeshlab's normal estimation + Kazhdan screened Poisson.
pymeshlab is an optional host dependency (eval-only, SURVEY §7);
import errors surface as a clear RuntimeError.
"""

from __future__ import annotations

import numpy as np


def screened_poisson(points, normals=None, k=10, smoothiter=0,
                     flipflag=False, viewpos=np.zeros(3),
                     visiblelayer=False, depth=8, fulldepth=5, cgdepth=0,
                     scale=1.1, samplespernode=1.5, pointweight=4,
                     iters=8, confidence=False, preclean=False, threads=8):
    """Run screened Poisson reconstruction; returns (vertices, faces)."""
    try:
        import pymeshlab
    except ImportError as e:
        raise RuntimeError(
            'screened_poisson requires the optional pymeshlab package '
            '(host-side competitor baseline, not part of the fit path)'
        ) from e

    ms = pymeshlab.MeshSet()
    if normals is not None:
        m = pymeshlab.Mesh(vertex_matrix=points.astype(np.float64),
                           v_normals_matrix=normals.astype(np.float64))
        ms.add_mesh(m)
    else:
        m = pymeshlab.Mesh(vertex_matrix=points.astype(np.float64))
        ms.add_mesh(m)
        try:
            ms.compute_normal_for_point_clouds(
                k=k, smoothiter=smoothiter, flipflag=flipflag,
                viewpos=viewpos)
        except AttributeError:   # older pymeshlab naming
            ms.compute_normals_for_point_sets(
                k=k, smoothiter=smoothiter, flipflag=flipflag,
                viewpos=viewpos)

    try:
        ms.generate_surface_reconstruction_screened_poisson(
            visiblelayer=visiblelayer, depth=depth, fulldepth=fulldepth,
            cgdepth=cgdepth, scale=scale, samplespernode=samplespernode,
            pointweight=pointweight, iters=iters, confidence=confidence,
            preclean=preclean, threads=threads)
    except AttributeError:
        ms.surface_reconstruction_screened_poisson(
            visiblelayer=visiblelayer, depth=depth, fulldepth=fulldepth,
            cgdepth=cgdepth, scale=scale, samplespernode=samplespernode,
            pointweight=pointweight, iters=iters, confidence=confidence,
            preclean=preclean, threads=threads)

    mesh = ms.current_mesh()
    return (np.asarray(mesh.vertex_matrix(), dtype=np.float32),
            np.asarray(mesh.face_matrix(), dtype=np.int32))
