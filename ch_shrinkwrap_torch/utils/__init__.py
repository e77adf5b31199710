from .math import (
    fast_3x3_cross,
    dot2,
    loc_error,
)
from . import tracing, checkpoint
