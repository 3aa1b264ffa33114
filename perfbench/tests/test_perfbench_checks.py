"""The comparison that decides ``correct`` can fail.

The control (the plain reference in the program's place, one precision
below the configuration's: TF32 in the guidance's products, float32 point
sums in the rollouts) moves the compared numbers at a size that the CPU
holds (TF32 exists only on the card, so there the rollouts' sums alone
move them), and comes out not correct at each cell's own size on the card.

Each fault that a cell can have, planted under the timed path, makes a run
come out not correct: a step that returns its state unchanged; half of the
batch left out; an answer altered where it is produced. (Both cells run
on one chip: there is no exchange between chips to leave out.)
"""

import pytest
import torch

from perfbench import harness, run
from perfbench.tests import small

SEED = 2 ** 31 + 4242


def _run(cell, control=False, device=small.CPU, seconds=1.0):
    out = run.run_cell(cell, SEED, seconds, False, device, control=control)
    return out["correct"], {k: v["value"] for k, v in
                            out["compared"].items()}


def test_control_moves_the_compared_numbers_on_the_cpu():
    cell = small.design_cell(verify_steps=400, regrasp=200)
    ok, sound = _run(cell)
    assert ok and all(v == 0.0 for v in sound.values())
    _, control = _run(cell, control=True, seconds=0.1)
    assert control["final_theta_gap_rad"] > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgdm-2d.design", "dgdm-3d.datagen"])
def test_control_is_not_correct_at_the_cells_size(name, cuda_device):
    ok, numbers = _run(harness.load_cell(name), control=True,
                       device=cuda_device, seconds=0.1)
    assert not ok, numbers


def _fault_2d(monkeypatch, kind):
    from dgdm_tpu_torch.diffusion import ddim
    from dgdm_tpu_torch.sim import rollout2d

    real = rollout2d.rollout
    if kind == "state_unchanged":
        # every DDIM step returns the sample it was given
        monkeypatch.setattr(ddim, "ddim_step",
                            lambda sched, eps, t, pt, x: x)
    elif kind == "half_batch":
        def half(coefs, *a, **kw):
            h = coefs.shape[0] // 2
            out = real(coefs[:h], *(x[:h] for x in a[:3]), *a[3:], **kw)
            return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)
        monkeypatch.setattr(rollout2d, "rollout", half)
    else:
        def altered(*a, **kw):
            out = list(real(*a, **kw))
            out[3] = out[3].clone()
            out[3][0, 0] += 1.5
            return tuple(out)
        monkeypatch.setattr(rollout2d, "rollout", altered)


def _fault_3d(monkeypatch, kind):
    from dgdm_tpu_torch.sim import rollout3d

    real = rollout3d.rollout
    if kind == "state_unchanged":
        # one step taken where the datagen depth is asked for
        def one(*a, **kw):
            return real(*a, **dict(kw, steps=1))
        monkeypatch.setattr(rollout3d, "rollout", one)
    elif kind == "half_batch":
        def half(coefs, points, scalars, poses, **kw):
            h = coefs.shape[0] // 2
            out = real(coefs[:h], points[:h], scalars[:h], poses, **kw)
            return tuple(torch.cat([o, torch.zeros_like(o)]) for o in out)
        monkeypatch.setattr(rollout3d, "rollout", half)
    else:
        def altered(*a, **kw):
            out = list(real(*a, **kw))
            # every pair's first rollout: the snapshot's quaternion z
            # (OUT_NAMES: sqz), which the kept dtheta reads
            out[6] = out[6].clone()
            out[6][:, 0] += 0.1
            return tuple(out)
        monkeypatch.setattr(rollout3d, "rollout", altered)


FAULTS = ["state_unchanged", "half_batch", "altered_answer"]


@pytest.mark.parametrize("kind", FAULTS)
def test_design_fault_is_not_correct(monkeypatch, kind):
    _fault_2d(monkeypatch, kind)
    ok, numbers = _run(small.design_cell(verify_steps=300, regrasp=150))
    assert not ok, numbers


@pytest.mark.parametrize("kind", FAULTS)
def test_datagen_fault_is_not_correct(monkeypatch, kind):
    _fault_3d(monkeypatch, kind)
    ok, numbers = _run(small.datagen_cell())
    assert not ok, numbers
