"""The port's design objectives and flag parser against the JAX package:
``design/objectives.deltas_to_objective`` on seeded deltas (exact for the
sign-only objectives, 1e-7 relative for 'rotate'), the inputs of
tests/test_metrics.py, the guided sampler's linear weights
(``GuidedSampler2D._objective_weights``) against ``deltas_to_objective``
on the 2D and 3D pose grids, and ``core/flags.parse`` on several argv
lists."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dgdm_tpu.core import flags as jflags
from dgdm_tpu.design import objectives as jobj
from dgdm_tpu_torch.core import flags as tflags
from dgdm_tpu_torch.design.guidance import GuidedSampler2D
from dgdm_tpu_torch.design.objectives import (
    SIMPLE_OBJECTIVES,
    deltas_to_objective,
)

OBJECTIVES = sorted(SIMPLE_OBJECTIVES) + ["convergence"]


def _deltas(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _centers(g, b, seed=0):
    """(b,) centers that include 0, G-1 and G//2, the rest drawn."""
    fixed = [0, g - 1, g // 2]
    drawn = np.random.RandomState(seed).randint(0, g, size=b - len(fixed))
    return np.concatenate([fixed, drawn]).astype(np.int64)


@pytest.mark.parametrize("objective", sorted(SIMPLE_OBJECTIVES))
def test_simple_objective_matches_jax(objective):
    d = _deltas((4, 9, 3), seed=1)
    ref = np.asarray(jobj.deltas_to_objective(jnp.asarray(d), objective))
    out = deltas_to_objective(torch.from_numpy(d), objective).numpy()
    assert out.shape == ref.shape == (4, 9)
    if objective == "rotate":
        np.testing.assert_allclose(out, ref, rtol=1e-7, atol=0)
    else:
        np.testing.assert_array_equal(out, ref)


# (grid, num_pos, batch): odd and even grids, so both halves of the wrap
# (offsets below and above the center) are hit from either end
@pytest.mark.parametrize("grid,num_pos,b", [(8, 1, 5), (9, 2, 4),
                                            (45, 5, 6), (360, 5, 6)])
@pytest.mark.parametrize("kind", ["tensor", "sequence"])
def test_convergence_matches_jax(grid, num_pos, b, kind):
    d = _deltas((b, grid * num_pos**2, 3), seed=grid)
    centers = _centers(grid, b, seed=grid)
    ref = np.asarray(jobj.deltas_to_objective(
        jnp.asarray(d), "convergence", grid_size=grid,
        centers=jnp.asarray(centers), num_pos=num_pos))
    c = torch.from_numpy(centers) if kind == "tensor" else centers.tolist()
    out = deltas_to_objective(torch.from_numpy(d), "convergence",
                              grid_size=grid, centers=c,
                              num_pos=num_pos).numpy()
    assert out.shape == ref.shape == (b, grid * num_pos**2)
    np.testing.assert_array_equal(out, ref)
    # each row: +d0 left of its center, -d0 at and right of it
    assert (np.abs(out) == np.abs(d[..., 0])).all()
    assert (out != -d[..., 0]).any() and (out != d[..., 0]).any()


def test_simple_objective_signs_port():
    """tests/test_metrics.py::test_simple_objective_signs on the port."""
    d = torch.tensor([[1.0, 2.0, 3.0]])
    assert float(SIMPLE_OBJECTIVES["rotate_clockwise"](d)[0]) == -1.0
    assert float(SIMPLE_OBJECTIVES["rotate_counterclockwise"](d)[0]) == 1.0
    assert float(SIMPLE_OBJECTIVES["shift_up"](d)[0]) == -2.0
    assert float(SIMPLE_OBJECTIVES["shift_right"](d)[0]) == 3.0
    assert float(SIMPLE_OBJECTIVES["clockwise_left"](d)[0]) == -4.0
    assert float(SIMPLE_OBJECTIVES["counterclockwise_down"](d)[0]) == 3.0
    assert float(deltas_to_objective(d, "rotate")[0]) == 1.0


def test_convergence_objective_signs_port():
    """tests/test_metrics.py::test_convergence_objective_signs on the
    port."""
    g, b = 8, 2
    deltas = torch.ones((b, g, 3))
    obj = deltas_to_objective(deltas, "convergence", grid_size=g,
                              centers=torch.tensor([0, 4]), num_pos=1)
    row = obj[0].reshape(g).numpy()
    assert row[5] == 1.0 and row[2] == -1.0


@pytest.mark.parametrize("missing", ["centers", "grid_size"])
def test_convergence_without_centers_raises(missing):
    kw = {"grid_size": 8, "centers": [0, 4]}
    kw[missing] = None
    with pytest.raises(ValueError):
        deltas_to_objective(torch.ones((2, 8, 3)), "convergence", **kw)


@pytest.mark.parametrize("grid", [360, 45], ids=["2d", "3d"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_objective_weights_match_deltas_to_objective(objective, grid):
    """The guided sampler's linear weights (N, 1-or-B, 3) give, summed with
    the deltas in its (pose, sample, 3) layout, what deltas_to_objective
    gives on the same deltas as (sample, pose, 3); 'rotate' is the square
    of component 0. Exact: each weight row has at most two non-zero entries
    of magnitude 1."""
    num_pos, b = 5, 16
    sampler = GuidedSampler2D(torch.nn.Identity(), torch.nn.Identity(),
                              grid_size=grid, num_pos=num_pos, device="cpu")
    n = grid * num_pos**2
    d = torch.from_numpy(_deltas((n, b, 3), seed=grid + len(objective)))
    centers = torch.from_numpy(_centers(grid, b, seed=grid + 1))
    w, rotate_sq = sampler._objective_weights(objective, centers, b)
    assert rotate_sq == (objective == "rotate")
    lin = d[..., 0] ** 2 if rotate_sq else (w * d).sum(-1)
    ref = deltas_to_objective(d.permute(1, 0, 2), objective, grid_size=grid,
                              centers=centers, num_pos=num_pos)
    assert lin.shape == (n, b) and ref.shape == (b, n)
    np.testing.assert_array_equal(lin.T.numpy(), ref.numpy())


def _every_flag_changed() -> list:
    """An argv that sets every flag of the JAX parser to a value other than
    its default."""
    argv = []
    for a in jflags.build_parser()._actions:
        if not a.option_strings or a.dest == "help":
            continue
        flag = a.option_strings[0]
        if a.nargs == 0:      # store_true / store_false
            if a.const != a.default:
                argv.append(flag)
        elif a.choices:
            argv += [flag, next(c for c in a.choices if c != a.default)]
        elif a.type is int:
            argv += [flag, str((a.default or 0) + 3)]
        elif a.type is float:
            argv += [flag, repr(2.0 * (a.default or 0.0) + 0.5)]
        else:
            argv += [flag, f"changed_{a.dest}"]
    return argv


@pytest.mark.parametrize("argv", [
    [], ["--fingers_3d"], ["--no_bf16", "--grid_size", "45"],
    _every_flag_changed(), ["--no_pallas", "--objectives", "shift_up,rotate",
                            "--learning_rate", "3e-4"],
    ["--device", "cpu"], ["--device", "cpu", "--fingers_3d", "--num_pos",
                          "3"],
], ids=["empty", "fingers_3d", "no_bf16_grid45", "every_flag", "mixed",
        "device_cpu", "device_cpu_3d"])
def test_parse_matches_jax(argv):
    port = vars(tflags.parse(argv))
    device = port.pop("device")
    j_argv = list(argv)
    if "--device" in j_argv:
        i = j_argv.index("--device")
        del j_argv[i:i + 2]
    assert port == vars(jflags.parse(j_argv))
    assert device == ("cpu" if "--device" in argv else "cuda")


def test_every_flag_argv_changes_every_value():
    defaults = vars(jflags.parse([]))
    changed = vars(jflags.parse(_every_flag_changed()))
    assert changed.keys() == defaults.keys()
    assert [k for k, v in defaults.items() if changed[k] == v] == []
