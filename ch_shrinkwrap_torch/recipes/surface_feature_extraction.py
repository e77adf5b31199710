"""Feature-extraction recipe modules.

Parity with
the reference ch_shrinkwrap/recipe_modules/surface_feature_extraction.py:
``SkeletonizeMembrane`` (mean-curvature-flow skeleton),
``PointsFromMesh``, ``AverageSquaredDistance``, ``MeshProperties``.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import (ModuleBase, register_module, Input, Output, CStr, Int,
                   Bool, Float, ColumnSource, DictSource, DictMDHandler)

logger = logging.getLogger(__name__)


@register_module('SkeletonizeMembrane')
class SkeletonizeMembrane(ModuleBase):
    """Mean-curvature-flow skeletonization (Tagliasacchi 2012;
    surface_feature_extraction.py:11-74)."""
    input = Input('surf')
    output = Output('skeleton')

    max_iters = Int(500)
    velocity_weight = Float(20.0)
    medial_axis_weight = Float(40.0)
    mesoskeleton = Bool(False)
    area_variation_factor = Float(0.0001)
    max_triangle_angle = Float(110.0)
    # rebuild extensions (models/skeleton_mesh.py): 'isotropic'
    # matches the reference's shipped behavior, 'skeleton' enables the
    # projection-split remesher; 'identity' is the stable Gauss-Newton
    # medial linearization, 'reference' the faithful one
    remesh_method = CStr('isotropic')
    medial_linearization = CStr('identity')

    def execute(self, namespace):
        from ..models.skeleton_mesh import SkeletonMesh

        mesh = SkeletonMesh(mesh=namespace[self.input],
                            max_iter=self.max_iters)

        # Upsample slightly to create better Voronoi poles
        l = 0.95 * mesh._mean_edge_length
        mesh.remesh(target_edge_length=l)

        mesh.shrink_wrap(None, None, method='skeleton',
                         lam=[self.medial_axis_weight],
                         area_variation_factor=self.area_variation_factor,
                         max_triangle_angle=self.max_triangle_angle,
                         remesh_method=self.remesh_method,
                         medial_linearization=self.medial_linearization)
        namespace[self.output] = mesh


@register_module('PointsFromMesh')
class PointsFromMesh(ModuleBase):
    input = Input('membrane0')
    output = Output('membrane0_localizations')

    dx_min = Float(5)
    p = Float(1.0)
    return_normals = Bool(True)

    def execute(self, namespace):
        from ..eval.metrics import points_from_mesh

        inp = namespace[self.input]
        md = DictMDHandler(getattr(inp, 'mdh', None))
        points, normals = points_from_mesh(inp, dx_min=self.dx_min,
                                           p=self.p, return_normals=True)
        ds = DictSource({'x': points[:, 0], 'y': points[:, 1],
                         'z': points[:, 2], 'xn': normals[:, 0],
                         'yn': normals[:, 1], 'zn': normals[:, 2]})
        self._params_to_metadata(md)
        ds.mdh = md
        namespace[self.output] = ds


@register_module('AverageSquaredDistance')
class AverageSquaredDistance(ModuleBase):
    input = Input('filtered_localizations')
    input2 = Input('filtered')
    output = Output('average_squared_distance')

    def execute(self, namespace):
        from ..eval.metrics import average_squared_distance

        inp = namespace[self.input]
        inp2 = namespace[self.input2]
        md = DictMDHandler(getattr(inp, 'mdh', None))
        md.mergeEntriesFrom(DictMDHandler(getattr(inp2, 'mdh', None)))

        points0 = np.vstack([inp['x'], inp['y'], inp['z']]).T
        points1 = np.vstack([inp2['x'], inp2['y'], inp2['z']]).T

        mse0, mse1 = average_squared_distance(points0, points1)
        mse = np.sqrt((mse0 + mse1) / 2)

        ds = DictSource({'mse01': np.atleast_1d(mse0),
                         'mse10': np.atleast_1d(mse1),
                         'mse_rms': np.atleast_1d(mse)})
        self._params_to_metadata(md)
        ds.mdh = md
        namespace[self.output] = ds


@register_module('MeshProperties')
class MeshProperties(ModuleBase):
    inputMesh = Input('membrane')
    output = Output('mesh_props')

    def run(self, inputMesh):
        _, n_comps = inputMesh.connected_components()
        return ColumnSource(
            euler=np.atleast_1d(inputMesh.euler_characteristic),
            genus=np.atleast_1d(inputMesh.genus),
            manifold=np.atleast_1d(int(inputMesh.is_manifold)),
            components=np.atleast_1d(n_comps))
