"""Mesh file I/O: binary STL and ascii PLY.

Counterpart of the STL I/O the reference inherits from PYME's
TriangleMesh (used for sweep artifacts, e.g.
ch_shrinkwrap/evaluation_utils_old.py:710-712).
"""

from __future__ import annotations

import struct

import numpy as np


def save_stl(filename, vertices, faces):
    """Write a binary STL file."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64)
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nn = np.linalg.norm(n, axis=1)
    n = n / np.maximum(nn, 1e-12)[:, None]

    F = faces.shape[0]
    rec = np.zeros(F, dtype=np.dtype([
        ('normal', '<3f4'), ('v0', '<3f4'), ('v1', '<3f4'), ('v2', '<3f4'),
        ('attr', '<u2')]))
    rec['normal'] = n
    rec['v0'] = tri[:, 0]
    rec['v1'] = tri[:, 1]
    rec['v2'] = tri[:, 2]
    with open(filename, 'wb') as f:
        f.write(b'ch_shrinkwrap_torch binary STL'.ljust(80, b' '))
        f.write(struct.pack('<I', F))
        f.write(rec.tobytes())


def load_stl(filename):
    """Read a binary (or ascii) STL file -> (vertices, faces), welded."""
    with open(filename, 'rb') as f:
        header = f.read(80)
        rest = f.read()
    if header[:5] == b'solid' and b'facet' in rest[:200]:
        tris = _parse_ascii_stl(header + rest)
    else:
        (count,) = struct.unpack('<I', rest[:4])
        rec = np.frombuffer(rest[4:4 + count * 50], dtype=np.dtype([
            ('normal', '<3f4'), ('v0', '<3f4'), ('v1', '<3f4'),
            ('v2', '<3f4'), ('attr', '<u2')]), count=count)
        tris = np.stack([rec['v0'], rec['v1'], rec['v2']], axis=1)
    return weld(tris)


def _parse_ascii_stl(data: bytes):
    verts = []
    for line in data.decode('ascii', errors='ignore').splitlines():
        parts = line.strip().split()
        if parts[:1] == ['vertex']:
            verts.append([float(x) for x in parts[1:4]])
    v = np.array(verts, dtype=np.float32)
    return v.reshape(-1, 3, 3)


def weld(tris, tol=0.0):
    """Merge duplicate vertices in an (F, 3, 3) triangle soup."""
    flat = np.asarray(tris, dtype=np.float32).reshape(-1, 3)
    if tol > 0:
        keyed = np.round(flat / tol).astype(np.int64)
    else:
        keyed = flat
    uniq, inv = np.unique(keyed, axis=0, return_inverse=True)
    # use first-seen position for each unique key
    first = np.full(len(uniq), len(flat), dtype=np.int64)
    np.minimum.at(first, inv, np.arange(len(flat)))
    vertices = flat[first]
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces produced by welding
    degen = ((faces[:, 0] == faces[:, 1]) | (faces[:, 1] == faces[:, 2])
             | (faces[:, 0] == faces[:, 2]))
    return vertices, faces[~degen]


def save_ply(filename, vertices, faces, colors=None):
    """Write an ascii PLY file, optionally with per-vertex uchar RGB."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int64)
    with open(filename, 'w') as f:
        f.write('ply\nformat ascii 1.0\n')
        f.write(f'element vertex {len(vertices)}\n')
        f.write('property float x\nproperty float y\nproperty float z\n')
        if colors is not None:
            f.write('property uchar red\nproperty uchar green\n'
                    'property uchar blue\n')
        f.write(f'element face {len(faces)}\n')
        f.write('property list uchar int vertex_index\nend_header\n')
        if colors is not None:
            for v, c in zip(vertices, colors):
                f.write(f'{v[0]} {v[1]} {v[2]} {int(c[0])} {int(c[1])} {int(c[2])}\n')
        else:
            for v in vertices:
                f.write(f'{v[0]} {v[1]} {v[2]}\n')
        for face in faces:
            f.write(f'3 {face[0]} {face[1]} {face[2]}\n')
