"""Datagen CLI — port of ``dgdm_tpu/cli/datagen.py`` (counterpart of the
reference ``sim/run_sim_2d.sh`` + ``sim/sim_2d.py``).

One invocation sweeps a range of objects x grippers through the rollout
kernel and writes reference-format npz shards. Objects come from an
Icons-50.npy file (``sim/sim_2d.py:24``) or, absent that, from deterministic
synthetic icons. The work is software-pipelined (``sim/pipeline.py``): the
bake of the next object's wave and the previous wave's npz writes run while
the current wave's kernel does, with the same npz output as
``sim.datagen.generate_2d``. ``main`` returns the summed pipeline summary.

Over N GPUs, start N processes with the environment contract of
``parallel/distributed.py``: each wave's pairs split over the ranks when
``--pairs_per_batch`` divides by N (``sim/datagen.py``), and rank 0 writes
the shards.

Example (reference: 1000 objects x 1000 grippers):
    python -m dgdm_tpu_torch.cli.datagen --object_dir Icons-50.npy \\
        --num_objects 1000 --num_fingers 1000 --save_dir data/sim2d
"""

from __future__ import annotations

import time

from dgdm_tpu_torch.core.flags import build_parser
from dgdm_tpu_torch.geom.contour import extract_contours, load_icon, synthetic_icon
from dgdm_tpu_torch.parallel.distributed import (
    maybe_initialize_distributed,
    rank,
)
from dgdm_tpu_torch.sim.pipeline import pipeline_2d


def add_totals(total: dict, out: dict) -> dict:
    """Sum the counts and seconds of pipeline summaries."""
    for k, v in out.items():
        if k != "rollouts_per_sec":
            total[k] = total.get(k, 0) + v
    return total


def main(argv=None):
    p = build_parser()
    p.add_argument("--num_objects", type=int, default=1)
    p.add_argument("--object_start", type=int, default=0)
    p.add_argument("--gripper_start", type=int, default=0)
    args = p.parse_args(argv)
    maybe_initialize_distributed()
    save_dir = args.save_dir if rank() == 0 else None

    def objects():
        for oi in range(args.object_start,
                        args.object_start + args.num_objects):
            image = (load_icon(args.object_dir, oi) if args.object_dir
                     else synthetic_icon(oi))
            yield oi, extract_contours(image)

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
        out = pipeline_2d(
            list(objects()), gidx, save_dir=save_dir,
            grid_size=args.grid_size, num_pos=args.num_pos,
            device=args.device,
        )
        add_totals(total, out)
        rate = total["rollouts"] / (time.perf_counter() - t0)
        print(
            f"grippers {gidx[0]}..{gidx[-1]} x {args.num_objects} objects "
            f"done ({rate:,.0f} rollouts/s cumulative)",
            flush=True,
        )
    total["wall_s"] = time.perf_counter() - t0
    return total


if __name__ == "__main__":
    main()
