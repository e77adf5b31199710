"""A cell at a size a CPU test run holds: the points cell's fit on 1000
localizations on an R = 50 nm sphere, 12 iterations with a neck pass
and a punch, through the port's plain versions, with limits for that
size (the block check's float32 against float64 reads about 1e-6 there,
its bfloat16 control about 0.1; the mean edge lies 0.10 from the
schedule, 0.61 with the remesh left out; the neck pass leaves none of
the 67 vertices it should cut, all of them when it is left out).  Twelve
iterations do not bring the seed surface onto an R = 50 nm sphere
(14 nm RMS), so ``shape_gap`` is held at the cell's size, not here."""

import json
import sys

CONFIG = {'cloud': {'shape': 'sphere', 'n_points': 1000, 'radius': 50.0,
                    'sigma': 5.0},
          'seed': {'offset': 25.0, 'grid_n': 12},
          'minimum_edge_length': 8.0, 'correspondence': 'brute'}
WORKLOAD = {'iterations': 12, 'punch_frequency': 6, 'neck_first_iter': 5,
            'warm_iterations': 6}
LIMITS = {'block_gap': 1e-3, 'surgery_gap': 5.0, 'edge_gap': 0.3,
          'neck_miss': 0.5, 'shape_gap': 25.0, 'defects': 0}
OVERRIDES = dict(config=CONFIG, workload=WORKLOAD, limits=LIMITS)
SEED = 5_000_000_011


def run(trace=0, control=False, seed=SEED, device='cpu', log=None):
    from benchmark import harness
    return harness.run_cell('points1m.northstar', seed, 0.01, trace,
                            device=device, overrides=OVERRIDES,
                            control=control, log=log or (lambda *a: None))


if __name__ == '__main__':
    print(json.dumps(run(int(sys.argv[1]) if len(sys.argv) > 1 else 0)))
