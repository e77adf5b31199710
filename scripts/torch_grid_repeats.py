"""Repeat chosen sweep-grid entries on the card, all at once each round,
to see whether their topology holds from run to run.

    python3 scripts/torch_grid_repeats.py 8             # chip_smoke's entries
    python3 scripts/torch_grid_repeats.py 8 test_necks_separator.yaml:146a65bb254c \\
        test_necks_separator.yaml:7264048d1733:recipe

Each round runs ``chip_smoke.phase_grids`` (one spawned worker an
entry, all entries at once) and prints one JSON line an entry (the
round, status, worker seconds, launches, Euler number, components,
``topology_correct``, ``sdf_rms``, ...) and one line with the round's
wall.  An entry is ``CONFIG:HASH``, with ``:recipe`` to run it through
the recipe route; without entries, ``chip_smoke.GRID_ENTRIES``.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

COLUMNS = ('sdf_rms', 'duration', 'ntriangles', 'euler', 'components',
           'manifold', 'topology_correct')


def parse(arg):
    config, entry, *rest = arg.split(':')
    return dict(config=config, entry=entry, via_recipe=rest == ['recipe'],
                sdf_ref=0.0, sdf_tol=0.0)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rounds = int(argv[0])
    entries = [parse(a) for a in argv[1:]] or list(chip_smoke.GRID_ENTRIES)
    for k in range(rounds):
        t0 = time.time()
        for r in chip_smoke.phase_grids(entries, timeout=300.0):
            row = r.pop('row') or {}
            r.pop('sdf_ref')
            r.pop('sdf_tol')
            print(json.dumps(dict(round=k, **r,
                                  **{c: row.get(c) for c in COLUMNS})),
                  flush=True)
        print(json.dumps(dict(round=k, wall_s=time.time() - t0)),
              flush=True)


if __name__ == '__main__':
    main()
