"""ch_shrinkwrap_torch — NanoWrap on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the JAX package that sits beside it in this
repository.  Module names follow the JAX package so every module's
counterpart is easy to find:

- ``mesh``    — host triangle mesh, remeshing, marching seed surface
                (numpy + the native C++ topology engine in ``native``).
- ``ops``     — device compute on torch tensors: normals, curvature,
                padded mesh arrays, nearest-face correspondence (brute,
                hash grid, blocked, windowed), and the
                three hand-written CUDA kernels (``cuda_window``,
                ``cuda_scatter``, ``cuda_gather``; sources in ``csrc/``,
                built by ``ops/_build.py``).
- ``solver``  — the conjugate-gradient block ``cg_block`` (with the
                shrink prior) and the Tikhonov CG solver (``tikhonov``).
- ``models``  — ``MembraneMesh`` and its ``shrink_wrap`` fit, with the
                topology surgery between CG blocks: neck removal,
                hole punching (``holepunch``; the SDF variant in
                ``holepunch_sdf``) and the Delaunay remesh; and
                ``SkeletonMesh`` (mean-curvature-flow skeleton).
- ``sim``     — signed-distance primitives, the shape library and the
                SMLM point-cloud simulation.
- ``eval``    — metrics against the shape oracles, the sweep harness
                (``python -m ch_shrinkwrap_torch.eval.harness``), the
                Delaunay hull surface and the optional competitors.
- ``recipes`` — the user-facing recipe modules and the YAML runner.
- ``utils``   — tracing and fit checkpoints (``checkpoint``, the JAX
                package's ``.npz`` keys).
- ``parallel`` — multi-device fits over ``torch.distributed``
                (``sharding``): the cloud sharded over ranks in whole
                256-point blocks, the face accumulators all-reduced.
                ``sharded_fit(model, pts, sigma, n_devices=2)`` runs a
                fit on two cards (NCCL);
                ``devices=['cuda:0', 'cuda:0']`` puts both ranks on one
                card (gloo), and a model on the CPU runs CPU ranks.
- ``animation`` — the fit one iteration a frame (matplotlib renders, or
                PLY meshes where matplotlib is absent).
- ``visgui_modules`` — the PYMEVis menu hooks (``Plug``).
- ``convert`` — carries fit state and whole models from numpy, or from
                the JAX package's objects, into the port.

Entry points run on ``cuda`` unless the caller passes
``device='cpu'``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"
