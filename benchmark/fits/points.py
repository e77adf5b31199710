"""A fit to a localization cloud: ``wrap_start`` then ``MembraneMesh``
then ``shrink_wrap``, as a user of the library writes it.

The cloud is drawn in set-up; every fit makes its own seed surface from
it (the ``seed`` span) and runs the whole schedule of the workload.
"""

import numpy as np

from ..cloud import sphere_cloud


class Fit:
    def __init__(self, config, workload, seed, device, spans):
        self.config, self.workload = config, workload
        self.device, self.spans = device, spans
        c = config['cloud']
        self.points, self.sigma = sphere_cloud(
            c['n_points'], c['radius'], c['sigma'], seed)
        # what the check holds the program's state to: the cloud's rows
        # with their inverse errors and residual weights
        self.inputs = dict(points=self.points,
                           sigma_inv=1.0 / self.sigma.astype(np.float64),
                           weights=np.ones(self.sigma.shape))

    def __call__(self, max_iter=None):
        from ch_shrinkwrap_torch.mesh.marching import wrap_start
        from ch_shrinkwrap_torch.models import MembraneMesh
        cfg, wl = self.config, self.workload
        with self.spans.span('seed'):
            surf = wrap_start(self.points, offset=cfg['seed']['offset'],
                              grid_n=cfg['seed']['grid_n'])
        mesh = MembraneMesh(
            mesh=surf, kc=cfg['kc'], step_size=cfg['curvature_weight'],
            max_iter=max_iter or wl['iterations'],
            remesh_frequency=wl['remesh_frequency'],
            delaunay_remesh_frequency=wl['punch_frequency'],
            delaunay_eps=wl['min_hole_radius'],
            neck_first_iter=wl['neck_first_iter'],
            neck_threshold_low=cfg['neck_threshold_low'],
            neck_threshold_high=cfg['neck_threshold_high'],
            device=self.device)
        mesh.shrink_wrap(self.points, self.sigma, method='conjugate_gradient',
                         minimum_edge_length=cfg['minimum_edge_length'])
        return mesh
