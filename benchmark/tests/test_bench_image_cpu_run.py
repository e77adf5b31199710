"""The image cell (``image5nm.recipe``) driven end to end on the CPU
through the port's plain versions, at a size a test holds, as
``bench_tiny`` does for the points cell: the run is ``correct`` and its
traced line reads the span metrics the manifest lists for the cell (no
device metric from a CPU run), and the bfloat16 control and each
fault of ``benchmark.faults`` planted in the timed path come out not
correct.

The tiny image is a 4 nm histogram of 3000 localizations on an
R = 60 nm sphere (2.7e3 weighted voxels), the seed ``wrap_start`` on a
12-cell grid, 12 iterations with a remesh every 5 to an 8 nm edge and a
neck pass at iteration 10, the exact search.  The tiny sphere has no
saddle and no spike (K 4e-5 to 7e-4), so the high neck threshold is
lowered to 5e-4 to give the pass a few vertices to cut (5 to 11 on the
seeds read): at the cell's thresholds it cuts none, and a pass left out
would go unseen.  Its limits, from its own readings (six seeds for the
sound run and three for the control, one for each fault):

* ``block_gap`` 1e-2: float32 against float64 reads 1.3e-6 to 1.4e-4
  here, and 8.3e-4 on one seed at the cell's thresholds (on a lattice
  more points sit near a tie between two faces than on a cloud); the
  bfloat16 control 0.123-0.128, an altered result 0.053, a block
  returning its state 1.0, half the cloud left out 1.67.
* ``edge_gap`` 0.2: the mean edge lies 0.044-0.068 from the schedule,
  0.318 with the remesh left out.
* ``neck_miss`` 0.5: the pass leaves none of the vertices it should
  cut, all of them when it is left out (1.0).
* ``surgery_gap`` 5 nm and ``defects`` 0, ``bench_tiny``'s (sound
  0.52-0.62 nm).
* ``shape_gap`` 25 nm: twelve iterations do not bring the seed onto the
  sphere (5.4-6.0 nm RMS), so the shape is held at the cell's size.
"""

import pytest

from benchmark import faults, harness

CONFIG = {'cloud': {'shape': 'sphere', 'n_points': 3000, 'radius': 60.0,
                    'sigma': 5.0},
          'voxel_nm': 4.0, 'seed': {'offset': 25.0, 'grid_n': 12},
          'minimum_edge_length': 8.0, 'correspondence': 'brute',
          'neck_threshold_high': 5e-4}
WORKLOAD = {'iterations': 12, 'warm_iterations': 5}
LIMITS = {'block_gap': 1e-2, 'surgery_gap': 5.0, 'edge_gap': 0.2,
          'neck_miss': 0.5, 'shape_gap': 25.0, 'defects': 0}
OVERRIDES = dict(config=CONFIG, workload=WORKLOAD, limits=LIMITS)
SEED = 5_000_000_017


def run(trace=0, control=False, seed=SEED, log=None):
    return harness.run_cell('image5nm.recipe', seed, 0.01, trace,
                            device='cpu', overrides=OVERRIDES,
                            control=control, log=log or (lambda *a: None))


@pytest.mark.parametrize('trace', [0, 1])
def test_image_cpu_run_line(trace):
    r = run(trace=trace)
    assert r['correct'] and r['failed'] == 0 and r['attempted'] >= 1, \
        r['compared']
    want = {'fit_s', 'setup_s'} if not trace else {
        'recipe_s', 'seed_s', 'seed_field_s', 'prep_s', 'remesh_s',
        'remesh_engine_s', 'surgery_s', 'rebuild_s', 'block_s', 'update_s'}
    assert set(r['metrics']) == want
    assert r['device']['platform'] == 'cpu'
    assert r['compared']['defects']['value'] == 0


def test_image_control_is_not_correct():
    r = run(control=True)
    assert not r['correct']
    gap = r['compared']['block_gap']
    assert gap['value'] > gap['limit']


@pytest.mark.parametrize('fault', faults.NAMES)
def test_image_fault_in_the_timed_path_is_not_correct(fault):
    undo = faults.plant(fault)
    try:
        r = run()
    finally:
        undo()
    assert not r['correct'], r['compared']
