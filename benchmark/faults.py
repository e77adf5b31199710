"""Faults planted under the timed path, for showing that ``correct``
comes out false: each is ``(owner, attribute, make)``, where ``make``
takes the original and returns its broken stand-in.

* ``unchanged``: a CG block returns its state unchanged;
* ``half_cloud``: a block leaves half the cloud out (the mean is then
  taken over the rest);
* ``altered``: a block's result is altered where it is produced;
* ``no_remesh``: the remesh does nothing;
* ``no_necks``: the neck pass removes nothing.

The cells run on one card, so none has an exchange between chips to
leave out.
"""


def _unchanged(orig):
    def block_call(positions, *a, **k):
        _, diag = orig(positions, *a, **k)
        return positions.clone(), diag
    return block_call


def _half_cloud(orig):
    def block_call(positions, faces, f_mask, v_mask, nbr_v, points,
                   sigma_inv, weights, point_mask, *a, **k):
        half = point_mask.clone()
        half[points.shape[0] // 2:] = False
        return orig(positions, faces, f_mask, v_mask, nbr_v, points,
                    sigma_inv, weights, half, *a, **k)
    return block_call


def _altered(orig):
    def block_call(*a, **k):
        f, diag = orig(*a, **k)
        f = f.clone()
        f[0] += 2.0
        return f, diag
    return block_call


def _no_remesh(orig):
    def remesh(self, *a, **k):
        return None
    return remesh


def _no_necks(orig):
    def remove_necks(self, *a, **k):
        return 0, 0
    return remove_necks


def _owners():
    from ch_shrinkwrap_torch.models import membrane_mesh as mm
    return mm, mm.MembraneMesh


def plant(name):
    """Puts fault ``name`` in place; returns a function that takes it
    out again."""
    mm, M = _owners()
    owner, attr, make = {
        'unchanged': (mm, 'block_call', _unchanged),
        'half_cloud': (mm, 'block_call', _half_cloud),
        'altered': (mm, 'block_call', _altered),
        'no_remesh': (M, 'remesh', _no_remesh),
        'no_necks': (M, 'remove_necks', _no_necks)}[name]
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    return lambda: setattr(owner, attr, orig)


NAMES = ('unchanged', 'half_cloud', 'altered', 'no_remesh', 'no_necks')
