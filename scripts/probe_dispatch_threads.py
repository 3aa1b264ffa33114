"""Whether two host threads dispatch the pure engines' eager steps faster
than one, on the card.

The render path's checks in chip_smoke.py phase 13 trace each design pair
alone (2D: 6 pairs x 400 steps, regrasp every 200; 3D: 3 pairs x 800
steps), ~1,000 CUDA kernels a step, each launched by the host. This runs
those traces in turn, after a warm-up: the 2D set then the 3D set on one
thread, and both sets at once on two threads, and prints the seconds of
each and whether the results agree bitwise.

    python scripts/probe_dispatch_threads.py      (on a machine with a GPU)
"""

from __future__ import annotations

import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dgdm_tpu_torch.geom import mesh3d  # noqa: E402
from dgdm_tpu_torch.geom.contour import (  # noqa: E402
    extract_contours,
    synthetic_icon,
)
from dgdm_tpu_torch.geom.fingers import (  # noqa: E402
    sample_gripper_2d,
    sample_gripper_3d,
)
from dgdm_tpu_torch.sim import engine2d, engine3d  # noqa: E402
from dgdm_tpu_torch.sim.types import to_device  # noqa: E402

MUG = os.path.join(ROOT, "tests", "fixtures", "scanned_objects", "mug_small",
                   "model.obj")


def main():
    dev = torch.device("cuda")
    contours = [extract_contours(synthetic_icon(i)) for i in (10000, 2009)]
    scenes2 = [engine2d.make_scene(*sample_gripper_2d(i), contours[i % 2])
               for i in range(6)]
    verts, faces = mesh3d.load_obj(MUG)
    scenes3 = [engine3d.with_hgrid(engine3d.make_scene(
        *sample_gripper_3d(i), verts, faces)) for i in range(3)]
    pose2 = torch.tensor([0.0, 0.0, np.pi], device=dev)
    pose3 = torch.tensor([0.0, 0.0, 0.7], device=dev)

    def alone_2d():
        with torch.inference_mode():
            return np.stack([engine2d.rollout_trace(
                to_device(s, dev), pose2, steps=400, every=20,
                regrasp_every=200).cpu().numpy() for s in scenes2])

    def alone_3d():
        with torch.inference_mode():
            return np.stack([engine3d.rollout_trace3d(
                to_device(s, dev), pose3, steps=800, every=20).cpu().numpy()
                for s in scenes3])

    alone_2d()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = alone_2d()
    t2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r3 = alone_3d()
    t3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        f2, f3 = pool.submit(alone_2d), pool.submit(alone_3d)
        q2, q3 = f2.result(), f3.result()
    both = time.perf_counter() - t0
    print(f"one thread: 2D {t2:.1f}s + 3D {t3:.1f}s = {t2 + t3:.1f}s; two "
          f"threads at once: {both:.1f}s; results bitwise equal: "
          f"{np.array_equal(r2, q2) and np.array_equal(r3, q3)}", flush=True)


if __name__ == "__main__":
    main()
