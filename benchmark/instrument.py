"""The benchmark's own spans and captures around the port's calls.

The port is not edited: the benchmark wraps, in its own process, the
module attributes the fit loop calls through.  Each wrapper opens a
``torch.profiler.record_function`` span named ``bench.<what>`` (free
when no profiler runs), and some also record:

* every kernel wrapper call (K1 ``window_min``, K2 ``windowed_ah`` /
  ``windowed_ahw2``, K2s ``segment_sum_ordered``, K3 ``row_gather``,
  K3f ``row_group_sum``), with the least time its inputs need
  (``counts.bounds``), while ``Spans.calls`` is a list;
* the CG blocks a check asks for: the block's starting state and its
  result, and the result of the block before it, by block index within
  the current fit; the first block's starting surface (the edge-length
  schedule starts from it);
* at the boundary before each such block, the surface the neck pass
  got and the vertices it left (host copies).
"""

import contextlib
import functools
import time

import torch

from .counts import bounds


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if torch.is_tensor(t))


class Spans:
    """Installs the wrappers; ``uninstall`` puts the originals back."""

    def __init__(self):
        self._saved = []
        self.calls = None          # list of (family, bound_s) while on
        self.capture = set()       # block indices to keep, in a fit
        self.captured = {}         # index -> dict, of the current fit
        self.start = None          # the first block's starting surface
        self.necks = {}            # index -> (vertices, faces, after)
        self.block_index = 0
        self.spans = {}            # name -> host seconds, this fit

    # -- installation -------------------------------------------------
    def _patch(self, owner, name, make):
        # the wrapper carries the original's attributes (the kernel
        # wrappers count their launches on themselves, by their global
        # name)
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, functools.wraps(orig)(make(orig)))

    def install(self):
        from ch_shrinkwrap_torch.models import membrane_mesh as mm
        from ch_shrinkwrap_torch.ops import cuda_scatter, cuda_window, \
            meshdata
        from ch_shrinkwrap_torch.solver import shrinkwrap as sw
        M = mm.MembraneMesh
        self._patch(M, 'remove_necks', self._necks)
        for name, label in (('remesh', 'remesh'),
                            ('remove_extra_short_edges', 'remesh'),
                            ('punch_holes', 'punch'),
                            ('spatial_sort', 'rebuild')):
            self._patch(M, name, lambda f, label=label: self._span(f, label))
        self._patch(meshdata, 'from_mesh',
                    lambda f: self._span(f, 'rebuild'))
        self._patch(meshdata, 'gather_tables',
                    lambda f: self._span(f, 'rebuild'))
        self._patch(mm, 'block_call', self._block)
        self._patch(cuda_window, 'window_min', self._k1)
        self._patch(sw, 'windowed_ah', lambda f: self._k2(f, 12))
        self._patch(sw, 'windowed_ahw2', lambda f: self._k2(f, 18))
        self._patch(cuda_scatter, 'segment_sum_ordered', self._k2s)
        self._patch(sw, 'row_gather', self._k3)
        self._patch(sw, 'row_group_sum', self._k3f)

    def uninstall(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    # -- per fit --------------------------------------------------------
    def new_fit(self):
        self.block_index = 0
        self.captured = {}
        self.start = None
        self.necks = {}
        self.spans = {}

    @contextlib.contextmanager
    def span(self, label):
        t0 = time.perf_counter()
        with torch.profiler.record_function('bench.' + label):
            yield
        self.spans[label] = self.spans.get(label, 0.0) \
            + time.perf_counter() - t0

    # -- wrappers -------------------------------------------------------
    def _span(self, f, label):
        def wrapped(*a, **k):
            with torch.profiler.record_function('bench.' + label):
                return f(*a, **k)
        return wrapped

    def _necks(self, f):
        # the neck pass runs after block i - 1 and before block i
        def wrapped(mesh, *a, **k):
            i = self.block_index
            keep = i in self.capture
            if keep:
                before = (mesh.vertices.copy(), mesh.faces.copy())
            with torch.profiler.record_function('bench.necks'):
                out = f(mesh, *a, **k)
            if keep:
                self.necks[i] = before + (mesh.vertices.copy(),)
            return out
        return wrapped

    def _block(self, f):
        names = ('positions', 'faces', 'f_mask', 'v_mask', 'nbr_v',
                 'points', 'sigma_inv', 'weights', 'point_mask', 'lam0',
                 'shrink_lam')

        def wrapped(*a, **k):
            with torch.profiler.record_function('bench.block'):
                out = f(*a, **k)
            i = self.block_index
            self.block_index += 1
            if i == 0:
                self.start = dict(zip(names[:4], a[:4]))
            if i in self.capture:
                state = dict(zip(names, a))
                state.update(k)
                state['result'] = out[0]
                self.captured[i] = state
            elif i + 1 in self.capture:
                self.captured[i] = dict(faces=a[1], f_mask=a[2],
                                        v_mask=a[3], result=out[0])
            return out
        return wrapped

    def _record(self, family, bound):
        if self.calls is not None:
            self.calls.append((family, bound[0]))

    def _k1(self, f):
        def wrapped(blocks_t, starts, centers_t, c2, sub_ids, window=2048,
                    n_anchors=3):
            with torch.profiler.record_function('bench.k1'):
                out = f(blocks_t, starts, centers_t, c2, sub_ids,
                        window=window, n_anchors=n_anchors)
            nb, _, B = blocks_t.shape
            Fp = centers_t.shape[1]
            self._record('k1', bounds.k1_bound(
                nb, B, n_anchors, window, sub_ids.numel(),
                -(-Fp // 128) * 128))
            return out
        return wrapped

    def _k2(self, f, out_cols):
        def wrapped(*a, **k):
            with torch.profiler.record_function('bench.k2'):
                out = f(*a, **k)
            tensors = [t for t in a if torch.is_tensor(t)]
            self._record('k2', bounds.k2_bound(
                a[0].shape[0], _nbytes(*tensors), k['num_segments'],
                out_cols))
            return out
        return wrapped

    def _k2s(self, f):
        def wrapped(rows, target, num_segments, init=None):
            with torch.profiler.record_function('bench.k2s'):
                out = f(rows, target, num_segments, init=init)
            self._record('k2s', bounds.k2s_bound(
                _nbytes(rows, target, init), num_segments,
                rows.shape[1] if rows.dim() == 2 else 1))
            return out
        return wrapped

    def _k3(self, f):
        def wrapped(src, idx):
            with torch.profiler.record_function('bench.k3'):
                out = f(src, idx)
            self._record('k3', bounds.gather_bound(_nbytes(src, idx),
                                                   _nbytes(out)))
            return out
        return wrapped

    def _k3f(self, f):
        def wrapped(src, idx, care):
            with torch.profiler.record_function('bench.k3f'):
                out = f(src, idx, care)
            self._record('k3', bounds.gather_bound(
                _nbytes(src, idx, care), _nbytes(out)))
            return out
        return wrapped
