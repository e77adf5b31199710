"""Generic N-direction Tikhonov-regularized subspace CG.

Public counterpart of the reference's reusable solver base class
``TikhonovConjugateGradient`` (the reference ch_shrinkwrap/
conj_grad.py:18-249, an ICTM variant): minimize

    || w (d - A f) ||^2 + sum_i lam_i^2 || L_i (f - fdef_i) ||^2

given user operator callables.  The production shrinkwrap path uses the
fused device implementation in ``solver.shrinkwrap`` (the operators
there run as torch ops on the fit's device); this class is the
composable version for custom operators.  The callables take numpy
float64 arrays, or, when the solver is given a ``device``, float64 torch
tensors on that device; either may return numpy arrays or tensors.
The reference's array-based legacy twin ``ShrinkwrapConjGrad``
(conj_grad.py:251-1045, dead in the production path per SURVEY §2) is
subsumed by this class plus the operators in ``ops.correspondence``.
"""

from __future__ import annotations

import numpy as np
import torch


class TikhonovConjugateGradient:
    """Subspace CG over directions [A^T r, -L_i^T L_i (f - fdef_i), step].

    Subclass or assign ``Afunc``/``Ahfunc`` and entries of
    ``Lfuncs``/``Lhfuncs`` (callables on flattened float arrays; torch
    tensors on ``device`` when one is given).
    """

    def __init__(self, Afunc=None, Ahfunc=None, Lfuncs=None, Lhfuncs=None,
                 device=None):
        self.device = None if device is None else torch.device(device)
        self.tests = []
        self.ress = []
        self.prefs = []
        if Afunc is not None:
            self.Afunc = Afunc
        if Ahfunc is not None:
            self.Ahfunc = Ahfunc
        self.Lfuncs = Lfuncs if Lfuncs is not None else [self.Lfunc]
        self.Lhfuncs = Lhfuncs if Lhfuncs is not None else [self.Lhfunc]

    # -- overridable operators -----------------------------------------
    def Afunc(self, f):
        raise NotImplementedError

    def Ahfunc(self, r):
        raise NotImplementedError

    def Lfunc(self, f):
        return f

    def Lhfunc(self, f):
        return f

    def start_guess(self, data):
        return np.array(data, dtype=np.float64, copy=True)

    def default_guess(self, default):
        return default * np.ones_like(self.f)

    def _apply(self, fn, x):
        """``fn(x)`` as a flat float64 numpy array, with ``x`` handed
        over as a tensor on ``self.device`` when one is set."""
        if self.device is not None:
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        y = fn(x)
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        return np.asarray(y, dtype=np.float64).ravel()

    def _stop_cond(self):
        if len(self.tests) < 3:
            return False
        a, b, c = self.tests[-3:]
        return (c < b) and (b < a) and (a < 1e-6)

    # -- the search ----------------------------------------------------
    def search(self, data, lams, defaults=None, num_iters=10, weights=1,
               pos=False, last_step=True):
        data = np.asarray(data, dtype=np.float64).ravel()
        if np.isscalar(lams):
            lams = [lams]
        lams = list(lams)

        if not np.isscalar(weights):
            weights = np.asarray(weights).ravel()
            self.mask = weights > 0
            weights = weights / weights.mean()
        else:
            self.mask = np.isfinite(data)

        self.fs = self.start_guess(data)
        self.f = np.asarray(self.fs, dtype=np.float64).ravel()

        n_smooth = min(len(self.Lfuncs), len(lams))
        if defaults is None:
            defaults = [self.default_guess(0.0) for _ in range(n_smooth)]

        n_search = n_smooth + 1
        s_size = n_search + 1
        S = np.zeros((self.f.size, s_size))

        self.loopcount = 0
        while self.loopcount < num_iters and not self._stop_cond():
            self.loopcount += 1
            res = weights * (data - self._apply(self.Afunc, self.f))

            S[:, 0] = self._apply(self.Ahfunc, res)
            prefs = []
            for i in range(n_smooth):
                p = self._apply(self.Lfuncs[i], self.f - defaults[i])
                prefs.append(p)
                S[:, i + 1] = -self._apply(self.Lhfuncs[i], p)

            # orthogonality test statistic
            test = 1.0
            pairs = [(i, j) for i in range(n_search)
                     for j in range(1, n_search) if i != j]
            for (i, j) in pairs:
                den = (np.linalg.norm(S[:, i]) * np.linalg.norm(S[:, j]))
                if den > 0:
                    test -= abs((S[:, i] * S[:, j]).sum()) / den / len(pairs)
            self.tests.append(test)
            self.ress.append(float(np.linalg.norm(res)))
            self.prefs.append([float(np.linalg.norm(p)) for p in prefs])

            fnew = self.subsearch(self.f, res[self.mask], defaults,
                                  lams[:n_smooth], S[:, :n_search])
            if pos:
                fnew = fnew * (fnew > 0)
            if last_step:
                S[:, s_size - 1] = fnew - self.f
                n_search = s_size
            self.S = S
            self.f[:] = fnew

        return self.f.reshape(np.shape(self.fs))

    def subsearch(self, f0, res, fdefs, lams, S):
        """Solve the small normal-equation system in the search
        subspace (conj_grad.py:183-229)."""
        n_search = S.shape[1]
        n_smooth = len(fdefs)
        prefs = [self._apply(self.Lfuncs[i], f0 - fdefs[i])
                 for i in range(n_smooth)]

        AS = np.zeros((res.size, n_search))
        LS = [np.zeros((prefs[i].size, n_search)) for i in range(n_smooth)]
        for k in range(n_search):
            AS[:, k] = self._apply(self.Afunc, S[:, k])[self.mask]
            for i in range(n_smooth):
                LS[i][:, k] = self._apply(self.Lfuncs[i], S[:, k])

        H = AS.T @ AS
        G = AS.T @ res
        for i in range(n_smooth):
            l2 = lams[i] * lams[i]
            H += l2 * (LS[i].T @ LS[i])
            G += l2 * (-LS[i].T @ prefs[i])

        c = np.linalg.solve(H + 1e-12 * np.eye(n_search), G)
        return f0 + S @ c
