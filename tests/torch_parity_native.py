"""Both native host engines, loaded for real, in every process that
runs the port's parity tests.  Holds no tests.

The JAX package's loader compiles ``libtopology.so`` straight onto its
shared path, so test workers that start at once can load a file that
another worker is still writing.  It then caches the failed load and
runs its numpy remesh passes for the rest of the process: another
algorithm, so another mesh, and a parity test that compares the port's
native engine with it reports a port fault that does not exist.

``load_both_engines`` points a JAX package that has not loaded its
library yet (or that cached a failed load) at a private per-process
copy, which no other process writes, and then requires both engines
to be loaded.  Each parity module calls it at import, which under
pytest-xdist is collection time: every worker is redirected before any
test runs in it.  A library already loaded is kept.
"""

import atexit
import ctypes
import os
import shutil
import subprocess
import tempfile


def _jax_engine_error(jnative):
    """Why the JAX package's engine did not load: the loader's error
    for a library on disk, else g++'s."""
    if os.path.exists(jnative._LIB):
        try:
            ctypes.CDLL(jnative._LIB)
        except OSError as e:
            return 'cannot load %s: %s' % (jnative._LIB, e)
    r = subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', os.devnull,
                        jnative._SRC], capture_output=True, text=True,
                       timeout=120)
    return 'g++ exit %d:\n%s' % (
        r.returncode, '\n'.join(r.stderr.strip().splitlines()[-20:]))


def load_both_engines():
    """Load the JAX package's and the port's native engines in this
    process, the JAX one from a private build unless it is already
    loaded; raise RuntimeError naming the engine that failed."""
    from ch_shrinkwrap_tpu import native as jnative
    from ch_shrinkwrap_torch import native as tnative

    # None: not loaded yet; False: a failed load, cached
    if jnative._lib is None or jnative._lib is False:
        d = tempfile.mkdtemp(prefix='csw-jax-native-')
        atexit.register(shutil.rmtree, d, True)
        jnative._LIB = os.path.join(d, 'libtopology.so')
        jnative._STAMP = jnative._LIB + '.srchash'
        jnative._lib = None
    if jnative.get_lib() is None:
        raise RuntimeError('the JAX package\'s native engine did not load '
                           '(%s): %s' % (jnative._LIB,
                                         _jax_engine_error(jnative)))
    try:
        tnative.get_lib()
    except RuntimeError as e:
        raise RuntimeError('the port\'s native engine did not load: %s'
                           % e) from e
