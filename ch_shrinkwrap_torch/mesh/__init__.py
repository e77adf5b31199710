from .core import TriangleMesh
from . import io as mesh_io
