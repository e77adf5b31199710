"""A fit of the NanoWrap sweep's ERSim entry: the density seed
``initial_surface_from_density``, then ``MembraneMesh`` and
``shrink_wrap`` as the port's sweep harness runs them
(``eval.harness.run_shrinkwrap_entry``), on a simulated acquisition.

The acquisition is drawn in set-up by the benchmark's own frozen copy of
the port's simulation (``benchmark.smlm``); every fit makes its own seed
surface from it (the ``seed`` span) and runs the whole schedule of the
workload.  The correspondence stays the model's ``'auto'``, the user's
path, which takes the brute-force search at this size.
"""

import numpy as np

from ..smlm import ersim_cloud


class Fit:
    def __init__(self, config, workload, seed, device, spans):
        self.config, self.workload = config, workload
        self.device, self.spans = device, spans
        self.points, self.sigma = ersim_cloud(config['cloud'], seed)
        # what the check holds the program's state to: the cloud's rows
        # with their inverse errors and residual weights, which a fit
        # given no weights takes as the inverse errors over their mean
        sigma_inv = 1.0 / self.sigma.astype(np.float64)
        self.inputs = dict(points=self.points, sigma_inv=sigma_inv,
                           weights=sigma_inv / sigma_inv.mean())

    def __call__(self, max_iter=None):
        from ch_shrinkwrap_torch.mesh.marching import \
            initial_surface_from_density
        from ch_shrinkwrap_torch.models import MembraneMesh
        cfg, wl = self.config, self.workload
        with self.spans.span('seed'):
            surf = initial_surface_from_density(
                self.points,
                threshold_density=cfg['seed']['threshold_density'],
                n_points_min=cfg['seed']['n_points_min'],
                grid_n=cfg['seed']['grid_n'])
        mesh = MembraneMesh(
            mesh=surf, device=self.device, kc=cfg['kc'],
            step_size=cfg['curvature_weight'],
            max_iter=max_iter or wl['iterations'],
            remesh_frequency=wl['remesh_frequency'],
            delaunay_remesh_frequency=wl['punch_frequency'],
            delaunay_eps=wl['min_hole_radius'],
            neck_first_iter=wl['neck_first_iter'],
            neck_threshold_low=cfg['neck_threshold_low'],
            neck_threshold_high=cfg['neck_threshold_high'])
        mesh.shrink_wrap(self.points, self.sigma, method='conjugate_gradient',
                         minimum_edge_length=cfg['minimum_edge_length'])
        return mesh
