"""Simulation recipe modules.

Parity with the reference ch_shrinkwrap/recipe_modules/simulation.py:
``PointcloudFromShape`` (named SDF shape -> SMLM cloud ColumnSource
with x/y/z, normals and per-point errors) and
``AddAllMetadataToPipeline``.
"""

from __future__ import annotations

import logging

import numpy as np

from .base import (ModuleBase, register_module, Input, Output, CStr, Int,
                   CInt, Bool, Float, List, ColumnSource, DictMDHandler)

logger = logging.getLogger(__name__)


@register_module('PointcloudFromShape')
class PointcloudFromShape(ModuleBase):
    output = Output('two_toruses')

    shape_name = CStr('TwoToruses')
    shape_params = CStr("{'r': 30, 'R': 100}")
    density = Float(1.0)
    p = Float(0.01)
    psf_width_x = Float(280.0)
    psf_width_y = Float(280.0)
    psf_width_z = Float(840.0)
    mean_photon_count = CInt(600)
    bg_photon_count = CInt(20)
    noise_fraction = Float(0.1)
    no_jitter = Bool(False)
    random_seed = Int(-1, desc='explicit seed; <0 -> nondeterministic')

    def execute(self, namespace):
        import yaml
        from ..sim.pointcloud import generate_smlm_pointcloud_from_shape

        params = yaml.safe_load(self.shape_params)
        psf_width = (None if self.no_jitter
                     else (self.psf_width_x, self.psf_width_y,
                           self.psf_width_z))
        rng = None if self.random_seed < 0 else self.random_seed
        points, normals, sigma = generate_smlm_pointcloud_from_shape(
            self.shape_name, params, density=self.density, p=self.p,
            psf_width=psf_width, mean_photon_count=self.mean_photon_count,
            bg_photon_count=self.bg_photon_count,
            noise_fraction=self.noise_fraction, rng=rng)

        if self.no_jitter:
            ds = ColumnSource(x=points[:, 0], y=points[:, 1], z=points[:, 2],
                              xn=normals[:, 0], yn=normals[:, 1],
                              zn=normals[:, 2])
        else:
            s = np.sqrt((sigma * sigma).sum(1))
            ds = ColumnSource(x=points[:, 0], y=points[:, 1], z=points[:, 2],
                              xn=normals[:, 0], yn=normals[:, 1],
                              zn=normals[:, 2],
                              sigma=s, error_x=sigma[:, 0],
                              error_y=sigma[:, 1], error_z=sigma[:, 2])

        md = DictMDHandler()
        self._params_to_metadata(md)
        ds.mdh = md
        namespace[self.output] = ds


@register_module('AddAllMetadataToPipeline')
class AddAllMetadataToPipeline(ModuleBase):
    """Broadcast every metadata entry of a measurement source into
    constant columns (simulation.py:63-100)."""
    inputMeasurements = Input('measurements')
    outputName = Output('annotatedMeasurements')
    additionalKeys = CStr('')
    additionalValues = CStr('')

    def execute(self, namespace):
        from .base import ColumnSource
        meas = namespace[self.inputMeasurements]
        res = dict(meas)

        add_keys = self.additionalKeys.split()
        add_values = self.additionalValues.split()
        n_entries = len(next(iter(res.values())))

        if add_keys and len(add_keys) == len(add_values):
            for k, v in zip(add_keys, add_values):
                res[k] = np.array([v] * n_entries, dtype='S40')

        for k in getattr(meas, 'mdh', {}).keys():
            v = meas.mdh[k]
            if isinstance(v, (list, tuple)):
                v = str(v)
            if isinstance(v, str):
                res[k] = np.array([v] * n_entries, dtype='S40')
            else:
                res[k] = np.array([v] * n_entries)

        out = ColumnSource(**{k: np.asarray(v) for k, v in res.items()})
        out.mdh = getattr(meas, 'mdh', DictMDHandler())
        namespace[self.outputName] = out
