"""The no-JAX check compares whole top-level module names."""

import sys
import types

from benchmark import harness


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ('ch_shrinkwrap_torch_extra', 'jaxlike', 'jaxlib2',
                 'flaxen.x'):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.delitem(sys.modules, 'jax', raising=False)
    monkeypatch.delitem(sys.modules, 'jaxlib', raising=False)
    monkeypatch.delitem(sys.modules, 'flax', raising=False)
    monkeypatch.delitem(sys.modules, 'ch_shrinkwrap_tpu', raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy',
                        types.ModuleType('jax.numpy'))
    assert harness.forbidden_modules() == ['jax']
    monkeypatch.setitem(sys.modules, 'ch_shrinkwrap_tpu.models',
                        types.ModuleType('ch_shrinkwrap_tpu.models'))
    assert harness.forbidden_modules() == ['ch_shrinkwrap_tpu', 'jax']


def test_reference_imports_nothing_of_the_port():
    """Every module under ``reference/``, the true shapes under
    ``reference/shapes/`` too."""
    import ast
    import os
    ref = os.path.join(harness.HERE, 'reference')
    files = [os.path.join(d, f) for d, _, fs in os.walk(ref) for f in fs
             if f.endswith('.py')]
    assert os.path.join(ref, 'shapes', 'ersim.py') in files
    for fn in files:
        with open(fn) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split('.')[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or '').split('.')[0]] \
                    if node.level == 0 else ['benchmark']
            else:
                continue
            for t in tops:
                assert t in ('numpy', 'torch', 'benchmark'), (fn, t)
