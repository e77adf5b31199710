"""The native host engines under the parity suite: a JAX package that
lost its build race is loaded again (``torch_parity_native``), the
port's loader stops with the compiler's error instead of running
another remesh, and the port's atomic build holds when processes build
and load at once.

Each case runs in fresh processes, so no state of this worker's loaded
engines is touched.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np

from test_torch_grids import thin_tube  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, 'tests')
ENV = {**os.environ, 'PYTHONPATH': REPO, 'JAX_PLATFORMS': 'cpu',
       'OMP_NUM_THREADS': '1'}


def engine_copy(tmp_path, source=None):
    """A copy of the port's ``native/`` without any built library;
    ``source`` replaces ``topology.cpp``.  Returns its ``__init__.py``."""
    dst = tmp_path / 'native'
    shutil.copytree(os.path.join(REPO, 'ch_shrinkwrap_torch', 'native'),
                    dst, ignore=shutil.ignore_patterns(
                        '*.so', '*.srchash', '*.tmp*', '__pycache__'))
    if source is not None:
        (dst / 'topology.cpp').write_text(source)
    return str(dst / '__init__.py')


def run(code, *args, timeout=120):
    r = subprocess.run([sys.executable, '-c', code, *args], cwd=REPO,
                       env=ENV, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


LOST_RACE = f"""
import os, sys
sys.path.insert(0, {TESTS!r})
import numpy as np
from ch_shrinkwrap_tpu import native as jnative
shared = jnative._LIB
jnative._lib = False            # a lost build race, cached
from torch_parity_native import load_both_engines
load_both_engines()
assert jnative._lib not in (None, False)
assert jnative._LIB != shared and os.path.exists(jnative._LIB)
from ch_shrinkwrap_tpu.mesh import remesh as jr
from ch_shrinkwrap_tpu.mesh.core import TriangleMesh as JTri
from ch_shrinkwrap_torch.mesh import remesh as tr
from ch_shrinkwrap_torch.mesh.core import TriangleMesh as TTri
d = np.load(sys.argv[1])
v, f = d['v'], d['f']
kw = dict(n_relax=0, collapse_veto_cos=0.5)
jm = jr.remesh(JTri(v.copy(), f.copy()), 5, 4.0, 0.5, **kw)
tm = tr.remesh(TTri(v.copy(), f.copy()), 5, 4.0, 0.5, **kw)
np.testing.assert_array_equal(tm.vertices, jm.vertices)
np.testing.assert_array_equal(tm.faces, jm.faces)
# the numpy passes the lost race used to run give another mesh
nm = jr.remesh(JTri(v.copy(), f.copy()), 5, 4.0, 0.5, use_native=False,
               **kw)
assert nm.vertices.shape != jm.vertices.shape
print('ok', jm.vertices.shape[0], nm.vertices.shape[0])
"""


def test_lost_race_reloads_jax_engine(thin_tube, tmp_path):  # noqa: F811
    """A cached failed load of the JAX package's engine is replaced by
    a private build, whose native remesh of the veto fixture equals the
    port's bit for bit."""
    v, f = thin_tube
    np.savez(tmp_path / 'tube.npz', v=v, f=f)
    out = run(LOST_RACE, str(tmp_path / 'tube.npz'))
    assert out.split()[0] == 'ok', out


LOUD_LOADER = """
import importlib.util, sys
import ch_shrinkwrap_torch
spec = importlib.util.spec_from_file_location(
    'ch_shrinkwrap_torch.native', sys.argv[1])
native = importlib.util.module_from_spec(spec)
sys.modules['ch_shrinkwrap_torch.native'] = native
spec.loader.exec_module(native)
ch_shrinkwrap_torch.native = native
for _ in range(2):             # a failure is raised again, not cached
    try:
        native.get_lib()
    except RuntimeError as e:
        msg = str(e)
    else:
        raise AssertionError('get_lib returned without a library')
    assert 'engine source that does not compile' in msg, msg
    assert native._LIB in msg, msg
    assert native._lib is None
from ch_shrinkwrap_torch.mesh.core import TriangleMesh
from ch_shrinkwrap_torch.mesh.primitives import icosphere
from ch_shrinkwrap_torch.mesh.remesh import remesh
v, f = icosphere(2, radius=10.0)
try:
    remesh(TriangleMesh(v, f), n=2, target_edge_length=2.0,
           use_native=True)
except RuntimeError as e:
    assert 'engine source that does not compile' in str(e), str(e)
else:
    raise AssertionError('remesh(use_native=True) ran without the engine')
print('ok')
"""


def test_port_loader_raises_with_compiler_error(tmp_path):
    """The port's ``get_lib`` raises with g++'s error and the library
    path when the engine does not compile, and the native remesh raises
    rather than running the numpy passes."""
    init = engine_copy(tmp_path, '#error engine source that does not '
                                 'compile\n')
    assert run(LOUD_LOADER, init).strip() == 'ok'


CONCURRENT_LOAD = """
import importlib.util, os, sys, time
go = sys.argv[2]
t0 = time.time()
while not os.path.exists(go):
    assert time.time() - t0 < 60, 'no start signal'
    time.sleep(0.005)
spec = importlib.util.spec_from_file_location('engine_copy', sys.argv[1])
native = importlib.util.module_from_spec(spec)
spec.loader.exec_module(native)
native.get_lib()
assert native.mean_edge(native.np.eye(3, dtype='f4'),
                        native.np.array([[0, 1, 2]], 'i4')) > 0
print('ok')
"""


def test_port_engine_concurrent_build_and_load(tmp_path):
    """Eight processes build and load a fresh copy of the port's engine
    at once (no library on disk): every one of them loads it."""
    init = engine_copy(tmp_path)
    go = str(tmp_path / 'go')
    procs = [subprocess.Popen([sys.executable, '-c', CONCURRENT_LOAD, init,
                               go], cwd=REPO, env=ENV, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for _ in range(8)]
    try:
        time.sleep(0.5)
        open(go, 'w').close()
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == 'ok', err[-2000:]
