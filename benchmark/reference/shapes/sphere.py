"""The sphere the points cells' cloud is drawn on (``cloud.sphere_cloud``:
radius ``cloud['radius']`` about the origin).

``gap`` is the RMS over the vertices of ‖v − centre‖ − R.  Every part of
a sphere is alike, so the RMS has no tail to follow: a sound fit reads
0.43–0.69 nm and a fit that leaves its seed unchanged 23–26 nm at the
cells' own sizes (PERF.md section 2).
"""

import torch

CENTRE = (0.0, 0.0, 0.0)


def gap(vertices, cloud):
    """RMS over the vertices of their distance from the sphere, nm."""
    centre = torch.tensor(CENTRE, dtype=torch.float64)
    r = torch.sqrt(((vertices - centre) ** 2).sum(1))
    return float(torch.sqrt(((r - cloud['radius']) ** 2).mean()))
