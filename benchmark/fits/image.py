"""A fit to a voxel image through the image recipe:
``ImageShrinkwrapMembrane`` on a histogram of a localization cloud, as
a user of the recipe runs it on a reconstructed volume.

The cloud is drawn and binned in set-up (``voxel_nm`` bins from the
cloud's lowest corner, the origin on the first bin's centre).  Every
fit makes its seed surface from the pseudo-localizations, since a user
of the recipe has only the image (the ``seed`` span), then runs the
recipe: its repair and remesh of the seed, the image's voxels above
zero as pseudo-localizations weighted by their values, and the fit with
the shrink prior.

``inputs`` holds the benchmark's own plain NumPy copy of the recipe's
rows: the pseudo-localizations (the recipe's float64 arithmetic, then
float32 as the fit takes them), their inverse errors (one over the
voxel size), and the residual weights the fit works with, the counts
over their mean (``counts`` keeps the counts themselves).
"""

import numpy as np

from ..cloud import sphere_cloud


class VoxelImage:
    """What the recipe reads of an image: ``data`` (nx, ny, nz),
    ``voxelsize_nm`` and ``origin``, the first voxel's centre."""

    def __init__(self, data, voxelsize_nm, origin):
        self.data, self.voxelsize_nm, self.origin = \
            data, voxelsize_nm, origin


def histogram(points, voxel):
    """The cloud binned at ``voxel`` nm from its lowest corner."""
    lo = points.min(0).astype(np.float64)
    n = np.maximum(np.ceil((points.max(0) - lo) / voxel).astype(int), 1)
    edges = [lo[k] + voxel * np.arange(n[k] + 1) for k in range(3)]
    data, _ = np.histogramdd(points, bins=edges)
    return VoxelImage(data.astype(np.float32), (voxel,) * 3,
                      tuple(float(x) for x in lo + voxel / 2.0))


def pseudo_localizations(image):
    """(rows (n, 3) float64, counts (n,)) of the voxels above zero, in
    the image's C order."""
    data = np.asarray(image.data)
    idx = np.nonzero(data.ravel() > 0)[0]
    ijk = np.stack(np.unravel_index(idx, data.shape), 1)
    rows = np.asarray(image.origin, np.float64) \
        + np.asarray(image.voxelsize_nm, np.float64) * ijk
    return rows, data.ravel()[idx]


class Fit:
    def __init__(self, config, workload, seed, device, spans):
        self.config, self.workload = config, workload
        self.device, self.spans = device, spans
        c = config['cloud']
        cloud, _ = sphere_cloud(c['n_points'], c['radius'], c['sigma'],
                                seed)
        voxel = float(config['voxel_nm'])
        self.image = histogram(cloud, voxel)
        rows, counts = pseudo_localizations(self.image)
        self.points = rows.astype(np.float32)
        w = np.repeat(counts, 3).reshape(-1, 3).astype(np.float32)
        self.inputs = dict(points=self.points,
                           sigma_inv=np.full(rows.shape, 1.0 / voxel),
                           weights=(w / w.mean()).astype(np.float32),
                           counts=counts)

    def __call__(self, max_iter=None):
        from ch_shrinkwrap_torch.mesh.marching import wrap_start
        from ch_shrinkwrap_torch.recipes.surface_fitting import \
            ImageShrinkwrapMembrane
        cfg, wl = self.config, self.workload
        with self.spans.span('seed'):
            surf = wrap_start(self.points, offset=cfg['seed']['offset'],
                              grid_n=cfg['seed']['grid_n'])
        mod = ImageShrinkwrapMembrane(
            input='surf', input_image='image', output='membrane',
            max_iters=max_iter or wl['iterations'],
            curvature_weight=cfg['curvature_weight'],
            shrink_weight=cfg['shrink_weight'], kc=cfg['kc'],
            remesh_frequency=wl['remesh_frequency'],
            cut_frequency=wl['punch_frequency'],
            min_hole_radius=wl['min_hole_radius'],
            neck_threshold_low=cfg['neck_threshold_low'],
            neck_threshold_high=cfg['neck_threshold_high'],
            neck_first_iter=wl['neck_first_iter'],
            minimum_edge_length=cfg['minimum_edge_length'],
            device=self.device)
        ns = {'surf': surf, 'image': self.image}
        mod.execute(ns)
        return ns['membrane']
