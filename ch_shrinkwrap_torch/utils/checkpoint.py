"""Fit checkpoint / resume.

The reference's resume mechanisms are implicit (SURVEY §5: cached
points/sigma for continuation, ``truncate_at`` early stop, per-stage
STL artifacts).  Here the fit state is explicit and serializable:
positions + topology + schedule step + cached cloud — a single ``.npz``
that fully restores a ``MembraneMesh`` mid-fit.  The keys are the JAX
package's, so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

# the fit parameters a checkpoint carries, by type
FLOAT_PARAMETERS = ('kc', 'kg', 'c0', 'step_size', 'delaunay_eps',
                    'neck_threshold_low', 'neck_threshold_high',
                    'neck_separator_threshold', 'neck_separator_median',
                    'neck_separator_constriction', 'shrink_weight')
INT_PARAMETERS = ('max_iter', 'remesh_frequency',
                  'delaunay_remesh_frequency', 'neck_first_iter')
FIT_PARAMETERS = FLOAT_PARAMETERS + INT_PARAMETERS + ('neck_detector',)


def save_fit_state(mesh, path, iteration=0):
    """Serialize a MembraneMesh fit state to ``path`` (.npz)."""
    payload = dict(vertices=mesh.vertices, faces=mesh.faces,
                   iteration=np.int64(iteration),
                   neck_detector=np.str_(mesh.neck_detector))
    payload.update({k: np.float64(getattr(mesh, k))
                    for k in FLOAT_PARAMETERS})
    payload.update({k: np.int64(getattr(mesh, k)) for k in INT_PARAMETERS})
    if mesh._points is not None:
        payload['points'] = mesh._points
    if mesh._sigma is not None:
        payload['sigma'] = np.asarray(mesh._sigma)
    np.savez_compressed(path, **payload)


def load_fit_state(path, device='cuda'):
    """Restore a MembraneMesh (and its cached cloud) from ``path``, with
    its fit on ``device``.

    Returns (mesh, iteration).  ``mesh.shrink_wrap()`` with no
    arguments continues the fit like the reference's cached-points path
    (_membrane_mesh.pyx:1650-1667).  Keys an older checkpoint lacks (the
    neck-detector settings) keep the model defaults.
    """
    from ..models.membrane_mesh import MembraneMesh

    with np.load(path, allow_pickle=False) as z:
        mesh = MembraneMesh(z['vertices'], z['faces'], device=device)
        for k in FLOAT_PARAMETERS:
            if k in z.files:
                setattr(mesh, k, float(z[k]))
        for k in INT_PARAMETERS:
            if k in z.files:
                setattr(mesh, k, int(z[k]))
        if 'neck_detector' in z.files:
            mesh.neck_detector = str(z['neck_detector'])
        if 'points' in z:
            mesh._points = z['points']
        if 'sigma' in z:
            mesh._sigma = z['sigma']
        return mesh, int(z['iteration'])
