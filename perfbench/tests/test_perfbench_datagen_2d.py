"""The 2D datagen cell (``dgdm-2d.datagen``, ``traffic/datagen_2d.py``) on
the CPU, at a size the CPU holds (2 icons a round, 2 grippers a wave, 4
poses padded to one 128-lane block, the datagen depth of 200 steps):

- the traffic sends whole rounds of the cell's 8 icons, and two seeds send
  the same block of grippers in another order;
- a configuration whose ``datagen_steps`` is not the program's depth is
  refused in set-up;
- a sound run is correct with every compared number 0, and the records it
  wrote equal the plain reference's rollouts (``reference/k1.py``);
- a traced run reports the cell's per-layer metrics (its two own and the
  two it shares with the 3D datagen cell) and the program's spans a wave;
- the control moves the compared numbers;
- each planted fault makes a run not correct: a rollout of 1 step where
  the datagen depth is asked for, half of the pairs left out, one record's
  ``delta_theta`` altered in the drain;
- on the card, the control is not correct at the cell's own size.
"""

import copy
import io
import math
import time

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.core.profiling import TRACER
from perfbench import harness, run
from perfbench.tests.test_perfbench_spans import ProfiledStandIn

CELL = "dgdm-2d.datagen"
SEED = 2 ** 31 + 4243
CPU = torch.device("cpu")
NEW = ("rollout_roofline.datagen2d", "mfu.datagen2d")
SHARED = ("idle_share.datagen", "bake_ms.datagen")
# a window this short closes after the first round: 2 waves, 4 pairs, every
# one of them compared
SHORT_S = 0.1


def small_cell():
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.config.update(grid_size=4, num_pos=1, num_objects=2)
    cell.params.update(pairs_per_wave=2, check_pairs=4)
    return cell


@pytest.fixture
def empty_tracer():
    TRACER.start()
    TRACER.stop()
    yield TRACER
    TRACER.start()
    TRACER.stop()


def _traffic(cell, seed=SEED, control=False):
    return harness.traffic_class(cell)(cell, seed, CPU, control=control)


def _run(traffic, seconds=SHORT_S, before_window=None):
    """Set-up, window, finish, comparison -> (correct, numbers)."""
    traffic.setup()
    if before_window is not None:
        before_window()
    traffic.window(seconds)
    traffic.finish()
    numbers = traffic.compare()
    ok, _ = harness.judge(numbers, harness.load_cell(CELL).limits)
    return ok, numbers


# -- the traffic ------------------------------------------------------------

def _sent(seed, seconds=0.3, wave_s=0.005):
    """The icons and grippers a window of the cell's own parameters sends,
    with the pipeline left out (each wave takes ``wave_s``)."""
    cell = harness.load_cell(CELL)
    traffic = _traffic(cell, seed)
    waves = []

    def stub(self):
        def pipeline(items, save_dir):
            for k, contour in items:
                waves.append(next(i for i, c in enumerate(self.contours)
                                  if c is contour))
                time.sleep(wave_s)
            n = len(waves)
            return {"waves": n, "pairs": n * len(self.grippers),
                    "rollouts": 0}
        self._pipeline = pipeline

    traffic._setup_program = stub.__get__(traffic)
    traffic._keep = lambda drained: None          # no rollouts to keep
    traffic.setup()
    del waves[:]                                  # the warm-up wave
    traffic.window(seconds)
    traffic.finish()
    return traffic, waves


def test_whole_rounds_of_the_icons():
    traffic, waves = _sent(2 ** 31 + 77)
    n = len(traffic.contours)
    assert (n, traffic.params["object_start"],
            traffic.cfg["num_objects"]) == (8, 0, 8)
    assert len(traffic.grippers) == 32
    assert len(waves) >= 2 * n and len(waves) % n == 0
    for r in range(len(waves) // n):
        assert sorted(waves[r * n:(r + 1) * n]) == list(range(n))


def test_seeds_send_the_same_block_in_another_order():
    a, wa = _sent(5, seconds=0.0)
    b, wb = _sent(2 ** 32 + 5, seconds=0.0)
    assert a.grippers != b.grippers
    assert sorted(a.grippers) == sorted(b.grippers)
    assert all(0 <= g < 1000 for g in a.grippers)
    assert sorted(wa) == sorted(wb) == list(range(8))


def test_setup_refuses_another_depth():
    cell = small_cell()
    cell.config["datagen_steps"] = 160
    with pytest.raises(ValueError, match="datagen_steps 160"):
        _traffic(cell).setup()


# -- correctness ------------------------------------------------------------

def test_sound_run_is_correct_and_its_records_are_the_reference():
    traffic = _traffic(small_cell())
    refs = []
    real = traffic._reference_outputs

    def kept(pairs, sum_group=0):
        refs.append((pairs, real(pairs, sum_group)))
        return refs[-1][1]

    traffic._reference_outputs = kept
    ok, numbers = _run(traffic)
    assert ok and numbers == {"dtheta_gap_rad": 0.0, "dpos_gap_m": 0.0}
    (pairs, ref), = refs
    assert pairs == [(w, s) for w in range(2) for s in range(2)]
    n = 4
    assert np.abs(ref[0, :, :n]).max() > 1e-2, "the jaws did not touch"
    for i, p in enumerate(pairs):
        raw, rec = traffic.checked[p]
        assert np.array_equal(rec["delta_theta"], ref[0, i, :n])
        assert np.array_equal(rec["delta_pos"][:, 0], ref[1, i, :n])
        assert np.array_equal(rec["delta_pos"][:, 1], ref[2, i, :n])
        assert np.array_equal(raw, ref[6:8, i])
    c, = {c["cfull"].shape for c in traffic.records["k1"]}
    assert c == (2, 1)


def test_traced_run_reports_the_metrics_and_spans(empty_tracer):
    log = io.StringIO()
    out = run.run_cell(small_cell(), SEED, SHORT_S, True, CPU,
                       tracer=ProfiledStandIn(), log=log)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(NEW + SHARED)
    assert all(v > 0.0 for v in m.values()), m
    assert "program spans a wave: datagen.arrays 1, datagen.records 1, " \
        "scene.object 2, scene.jaw_mass.native 0, " \
        "scene.jaw_mass.python 0" in log.getvalue()
    assert "program span ms a wave: datagen.arrays " in log.getvalue()


def test_control_moves_the_compared_numbers():
    ok, sound = _run(_traffic(small_cell()))
    assert ok and all(v == 0.0 for v in sound.values())
    _, control = _run(_traffic(small_cell(), control=True))
    assert control["dtheta_gap_rad"] > 0.0 and control["dpos_gap_m"] > 0.0


def _altered_once(monkeypatch):
    """From the window on, the next record the drain makes has its
    ``delta_theta`` altered."""
    from dgdm_tpu_torch.sim import datagen

    real = datagen.make_record
    left = [1]

    def altered(*a, **kw):
        rec = real(*a, **kw)
        if left[0]:
            left[0] -= 1
            rec["delta_theta"] = rec["delta_theta"].copy()
            rec["delta_theta"][0] += 1.5
        return rec

    return lambda: monkeypatch.setattr(datagen, "make_record", altered)


@pytest.mark.parametrize("kind", ["one_step", "half_pairs", "altered_record"])
def test_fault_is_not_correct(monkeypatch, kind):
    from dgdm_tpu_torch.sim import rollout2d

    real = rollout2d.rollout
    before_window = None
    if kind == "one_step":
        monkeypatch.setattr(rollout2d, "rollout",
                            lambda *a, **kw: real(*a, **dict(kw, steps=1)))
    elif kind == "half_pairs":
        def half(coefs, *a, **kw):
            h = coefs.shape[0] // 2
            out = real(coefs[:h], *(x[:h] for x in a[:3]), *a[3:], **kw)
            return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)
        monkeypatch.setattr(rollout2d, "rollout", half)
    else:
        before_window = _altered_once(monkeypatch)
    ok, numbers = _run(_traffic(small_cell()), before_window=before_window)
    assert not ok, numbers
    if kind == "altered_record":
        assert numbers["dtheta_gap_rad"] == pytest.approx(1.5, abs=1e-6)
    else:
        assert numbers["dtheta_gap_rad"] == pytest.approx(math.pi)


@pytest.mark.cuda
def test_control_is_not_correct_at_the_cells_size(cuda_device):
    out = run.run_cell(harness.load_cell(CELL), SEED, 0.1, False,
                       cuda_device, control=True)
    assert not out["correct"], out["compared"]
