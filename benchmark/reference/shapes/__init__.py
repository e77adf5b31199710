"""One module a true shape, named by a configuration's ``cloud.shape``:
``<shape>.py`` with ``gap(vertices, cloud)``, the distance in nm of the
final surface's used vertices, a (V, 3) float64 tensor, from the shape
the cloud was drawn on, reduced as the module's docstring states and
why.  ``cloud`` is the configuration's ``cloud`` dict.  Plain float64
PyTorch and NumPy; nothing of the program."""
