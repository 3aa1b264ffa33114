"""3D datagen CLI — port of ``dgdm_tpu/cli/datagen3d.py`` (counterpart of
the reference ``sim/run_sim_3d.sh`` + ``sim/sim_3d.py``).

Objects are directories containing ``model.obj`` (the MuJoCo
scanned-objects layout, ``sim/sim_3d.py:99-105``); names come from
``object_names.txt`` in --object_dir, else from the subdirectories that pass
the reference bbox filter (``assets/scan_object_process.py:42-56``).
Without --object_dir a synthetic box set is used. ``main`` returns the
summed pipeline summary.

Gripper blocks are the outer loop and objects the inner one (the reference
loops the other way, ``sim/run_sim_3d.sh``): each gripper's host geometry
(hull masses, surface fits) is computed once per block and served from
``engine3d._GRIP_CACHE`` and ``rollout3d``'s fit cache for every object,
and the OBJ parse is memoized across blocks.

Over N GPUs, start N processes with the environment contract of
``parallel/distributed.py``: each block's pairs split over the ranks when
``--pairs_per_batch`` divides by N, and rank 0 writes the shards.

Example (reference: 300 objects x 2000 grippers):
    python -m dgdm_tpu_torch.cli.datagen3d --object_dir scanned_objects \\
        --num_objects 300 --num_fingers 2000 --save_dir data/sim3d
"""

from __future__ import annotations

import os
import time

import numpy as np

from dgdm_tpu_torch.cli.datagen import add_totals
from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.geom import mesh3d
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
)
from dgdm_tpu_torch.sim.pipeline import pipeline_3d


def load_object_names(object_dir: str):
    path = os.path.join(object_dir, "object_names.txt")
    if os.path.exists(path):
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]
    names = []
    for d in sorted(os.listdir(object_dir)):
        obj = os.path.join(object_dir, d, "model.obj")
        if os.path.exists(obj):
            verts, _ = mesh3d.load_obj(obj)
            if mesh3d.filter_object(verts):
                names.append(d)
    return names


def synthetic_box(idx: int):
    rng = np.random.RandomState(idx)
    hx, hy = rng.uniform(0.02, 0.06, 2)
    hz = rng.uniform(0.02, 0.05)
    return mesh3d.box_mesh(hx, hy, hz, hz)


def main(argv=None):
    p = build_parser()
    p.add_argument("--num_objects", type=int, default=1)
    p.add_argument("--object_start", type=int, default=0)
    p.add_argument("--gripper_start", type=int, default=0)
    args = p.parse_args(argv)
    maybe_initialize_distributed()
    save_dir = args.save_dir if rank() == 0 else None

    names = load_object_names(args.object_dir) if args.object_dir else None
    obj_cache: dict = {}

    def load_object(oi):
        if oi not in obj_cache:
            if names is not None:
                name = names[oi]
                verts, faces = mesh3d.load_obj(
                    os.path.join(args.object_dir, name, "model.obj"))
            else:
                name = f"box_{oi}"
                verts, faces = synthetic_box(oi)
            obj_cache[oi] = (name, verts, faces)
        return obj_cache[oi]

    total: dict = {}
    t0 = time.perf_counter()
    for g0 in range(
        args.gripper_start, args.gripper_start + args.num_fingers,
        args.pairs_per_batch,
    ):
        gidx = list(
            range(g0, min(g0 + args.pairs_per_batch,
                          args.gripper_start + args.num_fingers))
        )
        items = [(oi,) + load_object(oi)
                 for oi in range(args.object_start,
                                 args.object_start + args.num_objects)]
        out = pipeline_3d(
            items, gidx, save_dir=save_dir,
            grid_size=args.grid_size, num_pos=args.num_pos,
            device=args.device,
        )
        add_totals(total, out)
        rate = total["rollouts"] / (time.perf_counter() - t0)
        print(
            f"grippers {gidx[0]}..{gidx[-1]} x {len(items)} objects: "
            f"{out['pairs_valid']}/{out['pairs']} kept (tip-over give-up), "
            f"{rate:,.0f} rollouts/s cumulative",
            flush=True,
        )
    total["wall_s"] = time.perf_counter() - t0
    return total


if __name__ == "__main__":
    main()
