"""Recipe infrastructure: traits-lite modules, tabular sources, YAML runner.

Standalone rebuild of the slice of PYME's recipe system the reference
plugs into (PYME.recipes.base / PYME.recipes.traits / PYME.IO.tabular,
used throughout the reference ch_shrinkwrap/recipe_modules/):
declarative modules with typed parameter traits, named inputs/outputs
flowing through a namespace dict, module registration by name, and a
YAML recipe document runner — without the PYME/wx dependency.
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np

logger = logging.getLogger(__name__)

MODULE_REGISTRY: Dict[str, type] = {}


def register_module(name):
    def deco(cls):
        MODULE_REGISTRY[name] = cls
        cls._module_name = name
        return cls
    return deco


class Trait:
    """Typed parameter descriptor with a default (traits-lite)."""

    def __init__(self, default=None, desc=''):
        self.default = default
        self.desc = desc

    def coerce(self, value):
        return value


class Int(Trait):
    def coerce(self, value):
        return int(value)


CInt = Int


class Float(Trait):
    def coerce(self, value):
        return float(value)


class Bool(Trait):
    def coerce(self, value):
        return bool(value)


class CStr(Trait):
    def __init__(self, default='', desc=''):
        super().__init__(default, desc)

    def coerce(self, value):
        return str(value)


class List(Trait):
    def __init__(self, default=None, desc=''):
        super().__init__(default if default is not None else [], desc)

    def coerce(self, value):
        return list(value)


class Enum(Trait):
    def __init__(self, values, desc=''):
        super().__init__(values[0] if values else None, desc)
        self.values = values

    def coerce(self, value):
        if self.values and value not in self.values:
            raise ValueError(f'{value!r} not in {self.values}')
        return value


class Input(CStr):
    pass


class Output(CStr):
    pass


class DictMDHandler(dict):
    """Metadata handler: a dict with PYME-ish helpers."""

    def __init__(self, other=None):
        super().__init__()
        if other:
            self.update(other)

    def mergeEntriesFrom(self, other):
        for k, v in (other or {}).items():
            self.setdefault(k, v)

    def keys(self):
        return super().keys()


class ColumnSource(dict):
    """Tabular datasource: named 1-D columns (PYME.IO.tabular-alike)."""

    def __init__(self, **columns):
        super().__init__()
        for k, v in columns.items():
            self[k] = np.asarray(v)
        self.mdh = DictMDHandler()

    def __getitem__(self, key):
        return dict.__getitem__(self, key)

    @property
    def n_rows(self):
        return len(next(iter(self.values()))) if self else 0


def DictSource(d):
    return ColumnSource(**d)


class ModuleBase:
    """Declarative recipe module: traits as class attributes, execute()
    reads/writes namespace entries named by Input/Output traits."""

    def __init__(self, **kwargs):
        for name, trait in self._traits().items():
            setattr(self, name, trait.default)
        for k, v in kwargs.items():
            traits = self._traits()
            if k in traits:
                setattr(self, k, traits[k].coerce(v))
            else:
                setattr(self, k, v)

    @classmethod
    def _traits(cls):
        out = {}
        for klass in reversed(cls.__mro__):
            for k, v in vars(klass).items():
                if isinstance(v, Trait):
                    out[k] = v
        return out

    def _params_to_metadata(self, md):
        prefix = f'Processing.{getattr(self, "_module_name", type(self).__name__)}'
        for name, trait in self._traits().items():
            if isinstance(trait, (Input, Output)):
                continue
            md[f'{prefix}.{name}'] = getattr(self, name)

    def execute(self, namespace):
        # default: delegate to run(<inputs>) -> output value
        traits = self._traits()
        inputs = {k: namespace[getattr(self, k)] for k, t in traits.items()
                  if isinstance(t, Input)}
        outs = [k for k, t in traits.items() if isinstance(t, Output)]
        result = self.run(**inputs)
        if len(outs) == 1:
            namespace[getattr(self, outs[0])] = result
        else:
            for k, v in zip(outs, result):
                namespace[getattr(self, k)] = v

    def run(self, **inputs):
        raise NotImplementedError

    def apply(self, **namespace):
        """Convenience: run on a fresh namespace, return it."""
        ns = dict(namespace)
        self.execute(ns)
        return ns


class Recipe:
    """Ordered list of modules executed against a shared namespace.

    YAML schema mirrors the reference recipes
    (the reference ch_shrinkwrap/test_evaluation_recipe.yaml): a list
    of single-key mappings ``{'group.ModuleName': {param: value}}``.
    """

    def __init__(self, modules):
        self.modules = modules

    @classmethod
    def from_yaml(cls, text):
        import yaml
        doc = yaml.safe_load(text)
        modules = []
        for entry in doc:
            (name, params), = entry.items()
            short = name.split('.')[-1]
            if short not in MODULE_REGISTRY:
                raise KeyError(f'unknown recipe module {name!r}')
            modules.append(MODULE_REGISTRY[short](**(params or {})))
        return cls(modules)

    def execute(self, namespace=None, **kwargs):
        ns = dict(namespace or {})
        ns.update(kwargs)
        for mod in self.modules:
            logger.info('recipe: executing %s', type(mod).__name__)
            mod.execute(ns)
        return ns
