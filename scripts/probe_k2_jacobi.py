"""K2's Jacobi instantiation (``rollout3d_kernel<32, 1>`` of
dgdm_tpu_torch/csrc/rollout3d.cu) on the card against the same kernel of
another checkout (an earlier commit's design), in one process on one card.

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python scripts/probe_k2_jacobi.py --other _parent --out F.json

Both sources are built with the port's nvcc flags (``ptxas -v``: registers,
spills) and held bitwise equal, on all 12 output planes, at P = 256, 200
and 17 contact points (the Jacobi golden fixture's pairs and poses, 800
steps; the kernel against its plain version at those counts is
tests/test_torch_rollout3d_cuda.py's). Then, with the Jacobi calibration,
chip_smoke.py phase 11's datagen shape (grippers 0-7 x mug_small x the
9,088-pose grid x 800 steps) and verification shape (grippers 100-115 x 45
orientations padded to 128 x 32,000 steps, regrasp and snapshot at 800),
both built by ``chip_smoke.k2_inputs``, are each timed in the order other,
this, this, other (CUDA events, one call each), the two kernels' outputs
held bitwise equal. Last, for each kernel: the verification shape at 15
grippers against 16 (the second wave of clusters: the card holds
``max_active_clusters`` of them at a time) and the datagen shape with no
sweeps (``solver_iters`` 0: the passes before them and the step's other
work).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dgdm_tpu_torch.core.config import SIM  # noqa: E402
from dgdm_tpu_torch.sim import engine3d, rollout3d  # noqa: E402
from dgdm_tpu_torch.sim.cuda_lib import CudaLibrary  # noqa: E402
from dgdm_tpu_torch.sim.rollout3d_ref import OUT_NAMES  # noqa: E402


def library(checkout: str, name: str) -> CudaLibrary:
    lib = CudaLibrary("rollout3d.cu", rollout3d._bind)
    lib.src = os.path.join(checkout, "dgdm_tpu_torch", "csrc", "rollout3d.cu")
    lib.name = name
    return lib


def jacobi_ptxas(what: str, lib: CudaLibrary) -> dict:
    """Registers and spill bytes of the Jacobi entry (``...ILi32ELi1EE...``)
    in the build log of ``lib``'s three instantiations."""
    (regs, spills), = [v for k, v in chip_smoke.ptxas_report(
        what, lib, n_kernels=3).items() if "ILi32ELi1EE" in k]
    return {"registers": regs, "spill_bytes": spills}


def timed(fn):
    return chip_smoke.timed_cuda(fn, reps=1, warm=False)


def same(x, y) -> list:
    """Names of the output planes that differ."""
    return [n for n, a, b in zip(OUT_NAMES, x, y) if not torch.equal(a, b)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="checkout whose csrc/rollout3d.cu is compared")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = {"this": rollout3d.LIBRARY,
            "other": library(os.path.abspath(args.other), "rollout3d_other")}
    res: dict = {"card": smi, "build": {}}
    for k, lib in libs.items():
        t0 = time.perf_counter()
        lib.build(force=True)
        res["build"][k] = dict(jacobi_ptxas(k, lib),
                               seconds=time.perf_counter() - t0)
        print(f"{k}: {res['build'][k]}", flush=True)
        lib.get()

    def run(which, *a, **kw):
        rollout3d.LIBRARY = libs[which]
        try:
            out = rollout3d.rollout_cuda(*a, **kw)
            return out, dict(rollout3d.LAST_PLAN)
        finally:
            rollout3d.LIBRARY = libs["this"]

    engine3d.SOLVER3 = "jacobi"
    # point counts that are no multiple of 32, and fewer than 32
    z = np.load(os.path.join(ROOT, "tests", "fixtures",
                             "rollout3d_jacobi_golden.npz"))
    garrs = [torch.as_tensor(z[k], device=dev)
             for k in ("coefs", "points", "scalars")]
    gposes = torch.as_tensor(z["poses"], device=dev)
    res["points"] = {}
    for p in (256, 200, 17):
        ga = [garrs[0], garrs[1][:, :p].contiguous(), garrs[2]]
        o_this, _ = run("this", *ga, gposes, 800, 0, 0)
        o_other, _ = run("other", *ga, gposes, 800, 0, 0)
        diff = same(o_this, o_other)
        res["points"][p] = diff
        print(f"P = {p}: planes differing {diff}", flush=True)
        if diff:
            raise SystemExit(f"P = {p}: the two kernels differ on {diff}")
    inp = chip_smoke.k2_inputs(dev)
    arrs8 = rollout3d.scene_arrays_3d(inp["scenes8"], device=dev)
    arrs16 = rollout3d.scene_arrays_3d(inp["scenes16"], device=dev)
    poses, eposes = inp["poses"], inp["eposes"]
    rg = SIM.eval_regrasp_3d
    shapes = {
        "datagen": (arrs8, poses, (SIM.steps_3d, 0, 0)),
        "verify": (arrs16, eposes, (SIM.eval_steps_3d, rg, rg)),
    }
    for name, (arrs, ps, sched) in shapes.items():
        ms, outs = {"this": [], "other": []}, {}
        for which in ("other", "this", "this", "other"):
            t, (o, plan) = timed(lambda: run(which, *arrs, ps, *sched))
            ms[which].append(t)
            outs[which] = o
            res.setdefault("plan", {})[which] = plan
        diff = same(outs["this"], outs["other"])
        res[name] = {"ms": ms, "planes_differing": diff}
        print(f"{name}: ms {ms}; planes differing {diff}; plans "
              f"{res['plan']}", flush=True)
        if diff:
            raise SystemExit(f"{name}: the two kernels differ on {diff}")

    # the verification shape at 15 grippers: one wave of clusters
    a15 = [a[:15].contiguous() for a in arrs16]
    res["tail"] = {}
    for which in ("this", "other"):
        t15, o15 = timed(lambda: run(which, *a15, eposes,
                                     *shapes["verify"][2]))
        res["tail"][which] = {"ms_15": t15, "ms_16": min(
            res["verify"]["ms"][which]), "plan": o15[1]}
        print(f"tail ({which}): 15 grippers {t15:.1f} ms, 16 "
              f"{res['tail'][which]['ms_16']:.1f} ms", flush=True)

    # the datagen shape with no sweeps
    old = engine3d.SOLVER_ITERS
    try:
        engine3d.SOLVER_ITERS = 0
        res["no_sweeps"] = {}
        for which in ("this", "other"):
            t0s, _ = timed(lambda: run(which, *arrs8, poses,
                                       *shapes["datagen"][2]))
            res["no_sweeps"][which] = t0s
        print(f"datagen with solver_iters 0: {res['no_sweeps']}", flush=True)
    finally:
        engine3d.SOLVER_ITERS = old

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: res[k] for k in ("datagen", "verify", "tail",
                                          "no_sweeps")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
