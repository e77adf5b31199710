"""Surface-fitting recipe modules — the user-facing NanoWrap API.

Parity with the reference ch_shrinkwrap/recipe_modules/surface_fitting.py:
same module names, same trait names and defaults (:17-42), same
input/output conventions (``surf`` mesh + ``filtered_localizations``
point source with x/y/z and error_x/y/z columns).  Every module that
builds a ``MembraneMesh`` has one trait more than the JAX package's:
``device``, the torch device of its fit (default ``'cuda'``).
"""

from __future__ import annotations

import logging
import time

import numpy as np

from .base import (ModuleBase, register_module, Input, Output, CStr, Int,
                   Bool, Float, List, DictMDHandler)

logger = logging.getLogger(__name__)


@register_module('ShrinkwrapMembrane')
class ShrinkwrapMembrane(ModuleBase):
    input = Input('surf')
    output = Output('membrane')
    points = Input('filtered_localizations')

    max_iters = Int(39)
    curvature_weight = Float(20.0)
    finishing_iters = Int(0)
    finishing_curvature_weight = Float(20.0)
    shrink_weight = Float(0)
    kc = Float(1.0)
    remesh_frequency = Int(5, desc='# of iterations between remesh operations')
    punch_frequency = Int(0, desc='# of iterations between hole punching attempts')
    min_hole_radius = Float(100.0)
    sigma_x = CStr('error_x')
    sigma_y = CStr('error_y')
    sigma_z = CStr('error_z')
    neck_threshold_low = Float(-1e-3, desc='curvature threshold for necks '
                               'characterised by negative curvature')
    neck_threshold_high = Float(1e-2, desc='curvature threshold for necks '
                                'characterised by +ve curvature')
    neck_first_iter = Int(9)
    neck_detector = CStr('threshold', desc="low-side neck criterion: "
                         "'threshold' (reference-identical) or "
                         "'separator' (connectivity-proven waist "
                         "rings; defeats the wrinkle-noise overlap "
                         "the pure threshold cannot resolve)")
    neck_separator_threshold = Float(-1e-5, desc='candidate K bound '
                                     'for the separator detector '
                                     '(grid-validated default; '
                                     'connectivity + median + '
                                     'constriction gates do the '
                                     'discrimination)')
    neck_separator_median = Float(-2e-4, desc='per-patch median-K '
                                  'coherence bound for the separator '
                                  'detector (a true waist ring is '
                                  'coherently negative)')
    neck_separator_constriction = Float(0.9, desc='max patch-ring '
                                        'radius over adjacent surface '
                                        'radius for the separator '
                                        'detector (a true neck '
                                        'constricts)')
    remesh_collapse_veto = Bool(False, desc='opt-in thin-tube pinch '
                                'protection: the remesh collapse pass '
                                'skips edges with strongly divergent '
                                'endpoint normals (a thinning '
                                'junction) unless pathologically '
                                'short')
    remesh_collapse_veto_cos = Float(0.5, desc='normal-dot bound for '
                                     'the collapse veto (0.5 = 60 deg)')
    truncate_at = Int(1000, desc='Truncate the iterations before max_iter')
    minimum_edge_length = Float(5)
    smooth_curvature = Bool(True, desc='Smooth curvature estimates')
    device = CStr('cuda', desc='torch device of the fit')

    def execute(self, namespace):
        from ..models.membrane_mesh import MembraneMesh

        inp = namespace[self.input]

        n_faces = len(inp.faces)
        if not n_faces > 4:
            raise RuntimeError('Input mesh only has %d faces, a valid '
                               'surface needs at least 4 faces' % n_faces)

        md = DictMDHandler(getattr(inp, 'mdh', None))
        mesh = MembraneMesh(mesh=inp, device=self.device,
                            kc=self.kc,
                            max_iter=self.max_iters,
                            step_size=self.curvature_weight,
                            remesh_frequency=self.remesh_frequency,
                            delaunay_remesh_frequency=self.punch_frequency,
                            delaunay_eps=self.min_hole_radius,
                            neck_threshold_low=self.neck_threshold_low,
                            neck_threshold_high=self.neck_threshold_high,
                            neck_first_iter=self.neck_first_iter,
                            neck_detector=self.neck_detector,
                            neck_separator_threshold=(
                                self.neck_separator_threshold),
                            neck_separator_median=(
                                self.neck_separator_median),
                            neck_separator_constriction=(
                                self.neck_separator_constriction),
                            remesh_collapse_veto=self.remesh_collapse_veto,
                            remesh_collapse_veto_cos=(
                                self.remesh_collapse_veto_cos),
                            shrink_weight=self.shrink_weight,
                            truncate_at=self.truncate_at)

        namespace[self.output] = mesh

        pts = np.ascontiguousarray(np.vstack([namespace[self.points]['x'],
                                              namespace[self.points]['y'],
                                              namespace[self.points]['z']]).T)
        try:
            sigma = np.vstack([namespace[self.points][self.sigma_x],
                               namespace[self.points][self.sigma_y],
                               namespace[self.points][self.sigma_z]]).T
        except Exception:
            try:
                sigma = namespace[self.points][self.sigma_x]
            except KeyError:
                logger.warning('%s not found in data source, defaulting to '
                               '10 nm precision.', self.sigma_x)
                sigma = 10 * np.ones_like(namespace[self.points]['x'])

        start = time.time()
        mesh.shrink_wrap(pts, sigma, method='conjugate_gradient',
                         minimum_edge_length=self.minimum_edge_length)

        if self.finishing_iters > 0:
            mesh.step_size = self.finishing_curvature_weight
            mesh.shrink_wrap(pts, sigma, method='conjugate_gradient',
                             minimum_edge_length=self.minimum_edge_length,
                             max_iter=self.finishing_iters)

        if self.smooth_curvature:
            mesh.smooth_curvature = self.smooth_curvature
            mesh._populate_curvature_grad()
        md['Processing.ShrinkwrapMembrane.Runtime'] = time.time() - start

        self._params_to_metadata(md)
        mesh.mdh = md


@register_module('InitialSurface')
class InitialSurface(ModuleBase):
    """Density-based initial wrap surface — replaces the reference
    pipeline's PYME Octree -> DualMarchingCubes seed
    (the reference ch_shrinkwrap/evaluation.py:69-87)."""
    input = Input('filtered_localizations')
    output = Output('surf')

    threshold_density = Float(-1.0, desc='points/nm^3 iso level; '
                              '<=0 -> auto (half median density)')
    n_points_min = Int(50)
    grid_n = Int(48)

    def execute(self, namespace):
        from ..mesh.marching import initial_surface_from_density
        inp = namespace[self.input]
        points = np.vstack([inp['x'], inp['y'], inp['z']]).T
        thr = self.threshold_density if self.threshold_density > 0 else None
        mesh = initial_surface_from_density(points, threshold_density=thr,
                                            n_points_min=self.n_points_min,
                                            grid_n=self.grid_n)
        md = DictMDHandler(getattr(inp, 'mdh', None))
        self._params_to_metadata(md)
        mesh.mdh = md
        namespace[self.output] = mesh


@register_module('ScreenedPoissonMesh')
class ScreenedPoissonMesh(ModuleBase):
    """Screened Poisson reconstruction competitor baseline (pymeshlab,
    optional dependency; surface_fitting.py:145-207)."""
    input = Input('filtered_localizations')
    output = Output('membrane')

    k = Int(10)
    smoothiter = Int(0)
    flipflag = Bool(False)
    viewpos = List([0, 0, 0])
    visiblelayer = Bool(False)
    depth = Int(8)
    fulldepth = Int(5)
    cgdepth = Int(0)
    scale = Float(1.1)
    samplespernode = Float(1.5)
    pointweight = Float(4)
    iters = Int(8)
    confidence = Bool(False)
    preclean = Bool(False)
    threads = Int(8)
    use_normals = Bool(False)
    device = CStr('cuda', desc='torch device of the fit')

    def execute(self, namespace):
        from ..models.membrane_mesh import MembraneMesh
        from ..eval.screened_poisson import screened_poisson

        inp = namespace[self.input]
        md = DictMDHandler(getattr(inp, 'mdh', None))
        points = np.ascontiguousarray(
            np.vstack([inp['x'], inp['y'], inp['z']]).T)
        normals = None
        if self.use_normals:
            try:
                normals = np.ascontiguousarray(
                    np.vstack([inp['xn'], inp['yn'], inp['zn']]).T)
            except KeyError:
                normals = None

        start = time.time()
        vertices, faces = screened_poisson(
            points, normals, k=self.k, smoothiter=self.smoothiter,
            flipflag=self.flipflag, viewpos=np.array(self.viewpos),
            visiblelayer=self.visiblelayer, depth=self.depth,
            fulldepth=self.fulldepth, cgdepth=self.cgdepth,
            scale=self.scale, samplespernode=self.samplespernode,
            pointweight=self.pointweight, iters=self.iters,
            confidence=self.confidence, preclean=self.preclean,
            threads=self.threads)
        md['Processing.ScreenedPoissonMesh.Runtime'] = time.time() - start
        self._params_to_metadata(md)

        mesh = MembraneMesh(vertices=vertices, faces=faces,
                            device=self.device)
        mesh.mdh = md
        namespace[self.output] = mesh


@register_module('AlphaWrap')
class AlphaWrap(ModuleBase):
    """CGAL alpha-wrap competitor baseline (optional dependency;
    surface_fitting.py:209-244)."""
    input = Input('filtered_localizations')
    output = Output('membrane')

    alpha = Float(20.0)
    offset = Float(0.001)
    device = CStr('cuda', desc='torch device of the fit')

    def execute(self, namespace):
        from ..models.membrane_mesh import MembraneMesh
        from ..eval.alpha_wrap import alpha_wrap

        inp = namespace[self.input]
        md = DictMDHandler(getattr(inp, 'mdh', None))
        points = np.ascontiguousarray(
            np.vstack([inp['x'], inp['y'], inp['z']]).T)

        start = time.time()
        vertices, faces = alpha_wrap(points, self.alpha, self.offset)
        md['Processing.AlphaWrap.Runtime'] = time.time() - start
        self._params_to_metadata(md)

        mesh = MembraneMesh(vertices=vertices, faces=faces,
                            device=self.device)
        mesh.mdh = md
        namespace[self.output] = mesh


@register_module('ImageShrinkwrapMembrane')
class ImageShrinkwrapMembrane(ModuleBase):
    """Shrinkwrap against a voxel image: every voxel above zero becomes
    a weighted pseudo-localization (surface_fitting.py:246-341)."""
    input = Input('surf')
    output = Output('membrane')
    input_image = Input('input')

    max_iters = Int(100)
    curvature_weight = Float(10.0)
    shrink_weight = Float(1.0)
    kc = Float(1.0)
    remesh_frequency = Int(5)
    cut_frequency = Int(0)
    min_hole_radius = Float(100.0)
    sigma_x = CStr('sigma_x')
    sigma_y = CStr('sigma_y')
    sigma_z = CStr('sigma_z')
    neck_threshold_low = Float(-1e-4)
    neck_threshold_high = Float(1e-2)
    neck_first_iter = Int(9)
    minimum_edge_length = Float(-1.0)
    device = CStr('cuda', desc='torch device of the fit')

    def execute(self, namespace):
        from ..models.membrane_mesh import MembraneMesh

        inp = namespace[self.input]
        n_faces = len(inp.faces)
        if not n_faces > 4:
            raise RuntimeError('Input mesh only has %d faces' % n_faces)

        mesh = MembraneMesh(mesh=inp, device=self.device,
                            kc=self.kc,
                            max_iter=self.max_iters,
                            step_size=self.curvature_weight,
                            remesh_frequency=self.remesh_frequency,
                            delaunay_remesh_frequency=self.cut_frequency,
                            delaunay_eps=self.min_hole_radius,
                            neck_threshold_low=self.neck_threshold_low,
                            neck_threshold_high=self.neck_threshold_high,
                            neck_first_iter=self.neck_first_iter,
                            shrink_weight=self.shrink_weight)
        mesh.repair()
        mesh.remesh()

        namespace[self.output] = mesh

        im = namespace[self.input_image]
        # image protocol: .data (nx, ny, nz), .voxelsize_nm, .origin
        weights = np.asarray(im.data)
        vx, vy, vz = im.voxelsize_nm
        ox, oy, oz = im.origin

        x, y, z = np.mgrid[0:weights.shape[0], 0:weights.shape[1],
                           0:weights.shape[2]]
        x = ox + vx * x.ravel()
        y = oy + vy * y.ravel()
        z = oz + vz * z.ravel()
        weights = weights.ravel()
        mask = weights > 0
        weights = weights[mask]

        pts = np.ascontiguousarray(np.vstack([x[mask], y[mask],
                                              z[mask]]).T)
        sigma = vx

        mesh.shrink_wrap(pts, sigma=sigma,
                         weights=np.repeat(weights, 3).reshape(-1, 3),
                         method='conjugate_gradient',
                         minimum_edge_length=self.minimum_edge_length)

        md = DictMDHandler(getattr(inp, 'mdh', None))
        self._params_to_metadata(md)
        mesh.mdh = md
