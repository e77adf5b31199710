"""Carry fit state from numpy into the port's tensors.

NanoWrap has no learned weights; what a fit carries is its padded mesh
arrays and its point cloud.  ``state_from_numpy`` takes that state as
numpy arrays — for example the ``MeshArrays`` fields and inputs of the
JAX package's ``cg_block``, fetched with ``np.asarray`` — and returns
the port's tensors with the port's dtypes, so both packages start from
identical bits.  ``membrane_mesh_from`` carries a whole model (mesh, fit
parameters and cached cloud) from any MembraneMesh-like object, the JAX
package's included; ``utils.checkpoint`` does the same through a
``.npz`` file that either package reads.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .ops.meshdata import MeshArrays

_MESH_DTYPES = {'positions': np.float32, 'v_mask': np.bool_,
                'faces': np.int32, 'f_mask': np.bool_, 'nbr_v': np.int32,
                'nbr_f': np.int32, 'face_nbrs': np.int32}


class FitState(NamedTuple):
    """A fit's padded mesh arrays and point cloud as tensors."""
    ma: MeshArrays
    points: Optional[torch.Tensor]      # (N, 3) f32
    sigma_inv: Optional[torch.Tensor]   # (N, 3) f32
    weights: Optional[torch.Tensor]     # (N, 3) f32
    point_mask: Optional[torch.Tensor]  # (N,) bool


def _tensor(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype=dtype, order='C',
                                     copy=True)).to(device)


def state_from_numpy(positions, v_mask, faces, f_mask, nbr_v, nbr_f=None,
                     face_nbrs=None, points=None, sigma_inv=None,
                     weights=None, point_mask=None, device='cuda'):
    """FitState on ``device`` from numpy arrays (copied, cast to
    float32 / int32 / bool).  A missing ``nbr_f`` or ``face_nbrs`` becomes
    a -1 table of the right shape; the host copies of the tables are
    kept in ``ma.host`` for ``meshdata.gather_tables``."""
    nbr_v = np.asarray(nbr_v)
    if nbr_f is None:
        nbr_f = np.full(nbr_v.shape, -1, np.int32)
    if face_nbrs is None:
        face_nbrs = np.full(np.shape(faces), -1, np.int32)
    arrays = dict(positions=positions, v_mask=v_mask, faces=faces,
                  f_mask=f_mask, nbr_v=nbr_v, nbr_f=nbr_f,
                  face_nbrs=face_nbrs)
    host = {k: np.ascontiguousarray(np.asarray(a), dtype=_MESH_DTYPES[k])
            for k, a in arrays.items() if k != 'positions'}
    host['V'] = int(host['v_mask'].sum())
    host['F'] = int(host['f_mask'].sum())
    ma = MeshArrays(**{k: _tensor(a, _MESH_DTYPES[k], device)
                       for k, a in arrays.items()}, host=host)

    def opt(a, dtype):
        return None if a is None else _tensor(a, dtype, device)

    return FitState(ma=ma, points=opt(points, np.float32),
                    sigma_inv=opt(sigma_inv, np.float32),
                    weights=opt(weights, np.float32),
                    point_mask=opt(point_mask, np.bool_))


def membrane_mesh_from(mesh, device='cuda'):
    """A port ``MembraneMesh`` on ``device`` with the vertices, faces,
    fit parameters, correspondence method, device count and cached
    cloud of ``mesh`` (any object with those attributes, for example
    the JAX package's MembraneMesh: its ``'windowed_pallas'`` is the
    port's ``'windowed'``, and a ``device_mesh`` becomes its device
    count)."""
    from .models.membrane_mesh import MembraneMesh
    from .solver.shrinkwrap import CORR_ALIASES
    from .utils.checkpoint import FIT_PARAMETERS
    out = MembraneMesh(np.asarray(mesh.vertices, np.float32),
                       np.asarray(mesh.faces, np.int32), device=device)
    for k in FIT_PARAMETERS:
        if hasattr(mesh, k):
            setattr(out, k, getattr(mesh, k))
    method = getattr(mesh, 'corr_method', None)
    if method is not None:
        out.corr_method = method if method == 'auto' \
            else CORR_ALIASES.get(method, method)
    dm = getattr(mesh, 'device_mesh', None)
    if dm is not None:
        # an int, or a mesh of devices (the JAX package's jax Mesh, or
        # the port's DeviceMesh)
        out.device_mesh = dm if isinstance(dm, (int, np.integer)) \
            else int(np.size(np.asarray(dm.devices, dtype=object)))
    pts = getattr(mesh, '_points', None)
    if pts is not None:
        out._points = np.asarray(pts)
        out._sigma = getattr(mesh, '_sigma', None)
    return out
