from .membrane_mesh import MembraneMesh, DESCENT_METHODS
