"""Package build for ch_shrinkwrap_tpu.

Counterpart of the reference's setup.py (which builds 4 native
extensions via numpy.distutils + cythonize, reference setup.py:21-34).
Here the only native piece is the C++ host topology engine, which
compiles itself lazily at import via g++ (see native/__init__.py), so
packaging is pure-python with the .cpp source shipped as package data.

The same distribution carries the PyTorch/CUDA port,
``ch_shrinkwrap_torch``: its CUDA sources (``csrc/*.cu``, compiled by
nvcc on first use) and its copy of the C++ topology engine ship as
package data too.
"""

from setuptools import setup, find_packages

setup(
    name='ch_shrinkwrap_tpu',
    version='0.1.0',
    description='TPU-native NanoWrap: membrane-mesh shrinkwrapping of '
                'SMLM point clouds (JAX/XLA)',
    packages=find_packages(include=['ch_shrinkwrap_tpu',
                                    'ch_shrinkwrap_tpu.*',
                                    'ch_shrinkwrap_torch',
                                    'ch_shrinkwrap_torch.*']),
    package_data={'ch_shrinkwrap_tpu.native': ['topology.cpp'],
                  'ch_shrinkwrap_torch': ['csrc/*.cu'],
                  'ch_shrinkwrap_torch.native': ['topology.cpp']},
    python_requires='>=3.10',
    install_requires=['numpy', 'scipy', 'jax', 'pyyaml'],
    extras_require={
        'eval': ['pymeshlab'],          # screened-Poisson baseline
        'gui': ['matplotlib', 'pillow'],
        'torch': ['torch'],             # ch_shrinkwrap_torch
    },
)
