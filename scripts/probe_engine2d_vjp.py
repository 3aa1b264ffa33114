"""How far float32 carries one step's gradient with respect to the
calibration knobs: the JAX engine's ``jax.vjp`` and the port's autograd of
``engine2d.step_newton`` in float32, against the port in float64.

Icon 3 x grippers 0-1 x 16 orientations, the JAX states after 180 steps
(both fingers touch the object somewhere), a random cotangent (seed 1), as
``tests/test_torch_engine2d.py::test_step_vjp_matches_jax`` takes them. For
each knob it prints: the largest per-pose difference of the two float32
gradients over the knob's largest per-pose entry; the difference of their
sums over the poses, over the sum and over the summed magnitudes; and at
the worst pose, each float32 gradient's distance from the float64 one.

    JAX_PLATFORMS=cpu python scripts/probe_engine2d_vjp.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from dgdm_tpu.geom.contour import extract_contours  # noqa: E402
from dgdm_tpu.geom.fingers import sample_gripper_2d  # noqa: E402
from dgdm_tpu.sim import engine2d as J  # noqa: E402
from dgdm_tpu_torch.sim import engine2d as T  # noqa: E402
from dgdm_tpu_torch.sim.types import State2D  # noqa: E402
from tests.util_icons import make_icon  # noqa: E402

FIELDS = ("com", "theta", "vel", "om", "zb", "vz", "q", "qd")
KNOBS = ("mu_plane", "mu_finger", "mu_torsion", "k_contact", "b_contact",
         "unload", "rough", "c_r")


def main():
    contour = extract_contours(make_icon(3))
    grips = [sample_gripper_2d(i) for i in range(2)]
    n = 16
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    poses = jnp.asarray(np.stack([np.zeros(n), np.zeros(n), th], -1),
                        jnp.float32)
    ctrl = jnp.asarray([0.2, -0.2], jnp.float32)
    cal0 = J.default_calib()
    rng = np.random.RandomState(1)
    rows = {k: [] for k in KNOBS}
    for b, g in enumerate(grips):
        js = J.make_scene(*g, contour)
        ts = T.make_scene(*g, contour)

        def adv(p, js=js):
            body = lambda s, _: (J.step(js, s, ctrl), None)  # noqa: E731
            return jax.lax.scan(body, J.init_state(js, p), None,
                                length=180)[0]

        states = jax.jit(jax.vmap(adv))(poses)
        for i in range(n):
            x = jax.tree.map(lambda a: a[i], states)
            out, vjp = jax.vjp(lambda c, s, js=js: J.step(js, s, ctrl,
                                                          calib=c), cal0, x)
            cot = jax.tree.map(lambda a: np.asarray(
                rng.normal(size=a.shape), np.float32), out)
            gj = vjp(jax.tree.map(jnp.asarray, cot))[0]
            got = {}
            for dt in (torch.float32, torch.float64):
                sc = type(ts)(**{f.name: getattr(ts, f.name).to(dt)
                                 for f in dataclasses.fields(ts)})
                cal = T.Calib(**{k: torch.tensor(float(getattr(cal0, k)),
                                                 dtype=dt, requires_grad=True)
                                 for k in KNOBS})
                st = State2D(**{k: torch.tensor(np.asarray(getattr(x, k)),
                                                dtype=dt) for k in FIELDS})
                o = T.step_newton(sc, st, torch.tensor([0.2, -0.2], dtype=dt),
                                  calib=cal)
                sum((getattr(o, k) * torch.tensor(getattr(cot, k), dtype=dt))
                    .sum() for k in FIELDS).backward()
                got[dt] = {k: 0.0 if getattr(cal, k).grad is None
                           else float(getattr(cal, k).grad) for k in KNOBS}
            for k in KNOBS:
                rows[k].append((float(getattr(gj, k)), got[torch.float32][k],
                                got[torch.float64][k]))
    for k in KNOBS:
        a = np.asarray(rows[k])                    # (poses, jax/f32/f64)
        jx, p32, p64 = a[:, 0], a[:, 1], a[:, 2]
        top = max(np.abs(jx).max(), 1e-30)
        w = int(np.argmax(np.abs(p32 - jx)))
        print(f"{k}: per pose max |port - jax| / max |jax| "
              f"{np.abs(p32 - jx).max() / top:.3g}; summed "
              f"{abs(p32.sum() - jx.sum()) / max(abs(jx.sum()), 1e-30):.3g} "
              f"of the sum, "
              f"{abs(p32.sum() - jx.sum()) / max(np.abs(jx).sum(), 1e-30):.3g}"
              f" of the summed magnitudes; worst pose {w}: jax "
              f"{abs(jx[w] - p64[w]) / max(abs(p64[w]), 1e-30):.3g}, port "
              f"{abs(p32[w] - p64[w]) / max(abs(p64[w]), 1e-30):.3g} from "
              f"float64")


if __name__ == "__main__":
    main()
