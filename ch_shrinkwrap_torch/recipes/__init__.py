from .base import (
    ModuleBase, register_module, Recipe, MODULE_REGISTRY,
    Input, Output, Int, CInt, Float, Bool, CStr, List, Enum,
    ColumnSource, DictSource, DictMDHandler,
)
from . import surface_fitting, simulation, surface_feature_extraction
