"""One instantiation of the hand-written rollout kernels against the same
instantiation built from another checkout (an earlier commit's design), in
one process on one card.

    mkdir -p _parent && git archive <commit> | tar -x -C _parent
    python scripts/probe_kernel_ab.py --other _parent --out F.json \\
        [--kernel k2_newton] [--kernel k2_newton_tol] [--kernel k2_jacobi] \\
        [--kernel k1_jacobi] [--kernel k1_newton]

``--kernel`` (repeatable; all five when absent) names the instantiation:
``k2_newton`` (``rollout3d_kernel<32, 0>`` of csrc/rollout3d.cu),
``k2_newton_tol`` (``<32, 2>``, ``newton_iters`` 6, ``newton_tol`` 1e-4),
``k2_jacobi`` (``<32, 1>``), ``k1_jacobi`` (``rollout2d_kernel<16, 1>``
of csrc/rollout2d.cu) or ``k1_newton`` (``<16, 0>``). Both checkouts'
sources are built with the port's nvcc flags, and each instantiation's
registers and spill bytes are read from ``ptxas -v``
(``chip_smoke.ptxas_report``); ``cuobjdump -sass`` of each built library
gives every instantiation's count of SASS instructions, of shuffles
(``SHFL``), conversions to and from float64 (``F2F.F64.F32``,
``F2F.F32.F64``) and float64 adds (``DADD``), and whether its instructions
and encodings equal the other build's (equal code is a finding, unequal
code not one by itself: ptxas has given K2's Newton instantiations other
code from the same source in a second build). For each kernel the two
builds are held bitwise equal on the output planes both write (K2's 12, K1's
first 8: an earlier K1 writes no contact count) at the point counts of
its card tests (K2: the kernel's golden fixture's pairs and poses with
their first 256, 200 and 17 points, 800 steps; K1: its fixture's with the
contour repeated to 100, 272 and 17 points, and for ``k1_newton`` to 384,
the most its slab takes, with 64 or 7 supports, 200 steps), then timed in
the order other, this, this, other (CUDA events, one call each, the outputs
held bitwise equal) at chip_smoke.py's shapes, built by
``chip_smoke.k2_inputs`` and ``chip_smoke.k1_inputs``:

- K2 datagen: grippers 0-7 x mug_small x the 9,088-pose grid x 800 steps
  (``k2_newton``, ``k2_jacobi``; ``k2_newton_tol`` with its adaptive loop
  and with the fixed count of one iteration, for the iterations a full step
  and the time an iteration takes, T(n) = a + b n between the two);
- K2 verification: grippers 100-115 x 45 orientations padded to 128 x
  32,000 steps, regrasp and snapshot at 800 (``k2_newton``, ``k2_jacobi``),
  and again at 15 grippers (the 16th cluster's second wave);
- K1 datagen: icon 0 x grippers 0-7 x 9,088 poses x 200 steps; K1
  verification: grippers 100-115 x 360 orientations padded to 384 x 8,000
  steps, regrasp and snapshot at 200 (``k1_jacobi``, ``k1_newton``);
- the Jacobi kernels' datagen shape with no sweeps (``solver_iters`` 0):
  the passes before them and the step's other work.

Beside each K1 case and timed shape it prints the contact share of this
build's solves: K1's plane 8 (each rollout's contour points in contact over
its full solves, or its solves with Jacobi) over P times plane 6 (its full
or Jacobi solve steps), the share of point visits that the Newton solve's
compacted contour passes keep.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dgdm_tpu_torch.core import native  # noqa: E402
from dgdm_tpu_torch.core.config import SIM  # noqa: E402
from dgdm_tpu_torch.sim import (engine2d, engine3d, rollout2d,  # noqa: E402
                                rollout3d)

# kernel -> (module, solver, keyword arguments, ptxas entry tag, golden)
KERNELS = {
    "k2_newton": (rollout3d, "newton", {}, "ILi32ELi0EE",
                  "rollout3d_golden.npz"),
    "k2_newton_tol": (rollout3d, "newton",
                      {"newton_iters": 6, "newton_tol": 1e-4},
                      "ILi32ELi2EE", "rollout3d_newton_tol_golden.npz"),
    "k2_jacobi": (rollout3d, "jacobi", {}, "ILi32ELi1EE",
                  "rollout3d_jacobi_golden.npz"),
    "k1_jacobi": (rollout2d, "jacobi", {}, "ILi16ELi1EE",
                  "rollout2d_jacobi_golden.npz"),
    "k1_newton": (rollout2d, "newton", {}, "ILi16ELi0EE",
                  "rollout2d_golden.npz"),
}


def library(mod, checkout: str) -> native.NativeLibrary:
    src = os.path.basename(mod.LIBRARY.src)
    lib = native.NativeLibrary(src, mod._bind, **native.NVCC)
    lib.src = os.path.join(checkout, "dgdm_tpu_torch", "csrc", src)
    lib.name = f"{mod.LIBRARY.name}_other"
    return lib


SASS_OPS = ("SHFL", "F2F.F64.F32", "F2F.F32.F64", "DADD")
# output planes that every build of the kernel writes
SHARED_PLANES = {rollout2d: 8, rollout3d: 12}


def sass(so: str) -> dict:
    """Each entry function of the library ``so``, by its mangled name
    without the anonymous namespace -> (its SASS instructions with their
    encodings, by ``cuobjdump -sass``; the count of each of SASS_OPS among
    their opcodes)."""
    tool = os.path.join(os.path.dirname(native.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    ins = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;"
                     r"\s*/\*\s*(0x[0-9a-f]+)")
    enc = re.compile(r"^\s*/\*\s*(0x[0-9a-f]+)\s*\*/\s*$")
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the anonymous namespace's name differs from build to build
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          m.group(1))
            cur = funcs.setdefault(name, [])
        elif cur is not None and (m := ins.match(line)):
            cur.append(f"{m.group(1)} {m.group(2)}")
        elif cur is not None and cur and (m := enc.match(line)):
            cur[-1] += f" {m.group(1)}"
    out = {}
    for name, lines in funcs.items():
        ops = [re.sub(r"^@!?U?P\w+\s+", "", x).split()[0] for x in lines]
        count = {"instructions": len(ops)}
        for op in SASS_OPS:
            count[op] = sum(o == op or o.startswith(op + ".") for o in ops)
        out[name] = (lines, count)
    return out


def same(x, y, planes: int) -> list:
    """Indices of the first ``planes`` output planes that differ."""
    return [i for i, (a, b) in enumerate(zip(x[:planes], y[:planes]))
            if not torch.equal(a, b)]


def contact_share(out, p: int) -> float:
    """K1's points in contact over the point visits of its solves."""
    return float(out[8].double().sum() / (p * out[6].double().sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="checkout whose csrc/*.cu are compared")
    ap.add_argument("--kernel", action="append", choices=sorted(KERNELS))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    kernels = args.kernel or list(KERNELS)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res: dict = {"card": smi, "build": {}}
    mods = {KERNELS[k][0] for k in kernels}
    libs = {}
    for mod in sorted(mods, key=lambda m: m.__name__):
        libs[mod] = {"this": mod.LIBRARY,
                     "other": library(mod, os.path.abspath(args.other))}
        for which, lib in libs[mod].items():
            t0 = time.perf_counter()
            lib.build(force=True)
            regs = chip_smoke.ptxas_report(
                f"{lib.name} ({which})", lib,
                n_kernels=2 if mod is rollout2d else 3)
            res["build"][f"{lib.name} ({which})"] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": {e: list(v) for e, v in regs.items()}}
            lib.get()
        # SASS instruction counts, and whether each entry's code is the
        # other build's
        code = {w: sass(lib.path()) for w, lib in libs[mod].items()}
        for entry, (lines, count) in sorted(code["this"].items()):
            other = code["other"].get(entry)
            row = {"this": count, "other": other and other[1],
                   "same_code": other is not None and other[0] == lines}
            res.setdefault("sass", {})[entry] = row
            print(f"  sass {entry}: {row}", flush=True)

    def run(mod, which, *a, **kw):
        mod.LIBRARY = libs[mod][which]
        try:
            out = mod.rollout_cuda(*a, **kw)
            return out, dict(mod.LAST_PLAN)
        finally:
            mod.LIBRARY = libs[mod]["this"]

    def timed(fn):
        return chip_smoke.timed_cuda(fn, reps=1, warm=False)

    def ab(name, mod, args_, kw):
        """other, this, this, other; the outputs bitwise equal."""
        ms, outs, plans = {"this": [], "other": []}, {}, {}
        for which in ("other", "this", "this", "other"):
            t, (o, plan) = timed(lambda: run(mod, which, *args_, **kw))
            ms[which].append(t)
            outs[which], plans[which] = o, plan
        diff = same(outs["this"], outs["other"], SHARED_PLANES[mod])
        row = {"ms": ms, "plans": plans}
        if mod is rollout2d:
            row["contact_share"] = contact_share(outs["this"],
                                                 args_[1].shape[1])
        print(f"  {name}: ms {ms}; planes differing {diff}; plans {plans}"
              + (f"; contact share {row['contact_share']:.5f}"
                 if "contact_share" in row else ""), flush=True)
        if diff:
            raise SystemExit(f"{name}: the two kernels differ on {diff}")
        return row, outs["this"]

    k2 = k1 = None
    for kname in kernels:
        mod, solver, kw, tag, fixture = KERNELS[kname]
        # (registers, spill bytes) of the instantiation in both builds
        r: dict = {"ptxas": {b: [v for e, v in d["ptxas"].items() if tag in e]
                             for b, d in res["build"].items()
                             if b.startswith(mod.LIBRARY.name)}}
        print(f"{kname}: {r['ptxas']}", flush=True)
        res[kname] = r
        z = np.load(os.path.join(ROOT, "tests", "fixtures", fixture))
        gposes = torch.as_tensor(z["poses"], device=dev)
        r["points"] = {}
        if mod is rollout3d:
            engine3d.SOLVER3 = solver
            coefs, points, scal = (torch.as_tensor(z[k], device=dev)
                                   for k in ("coefs", "points", "scalars"))
            cases = {f"P={p}": ((coefs, points[:, :p].contiguous(), scal),
                                (800, 0, 0)) for p in (256, 200, 17)}
        else:
            engine2d.SOLVER = solver
            coefs, contour, sup, scal = (
                torch.as_tensor(z[k], device=dev)
                for k in ("coefs", "contour", "support", "scalars"))
            rep = contour.repeat(1, 4, 1)
            counts = (100, 272, 384, 17) if solver == "newton" else (
                100, 272, 17)
            cases = {f"P={p},S={s}": ((coefs, rep[:, :p].contiguous(),
                                       sup[:, :s].contiguous(), scal),
                                      (200, 0, 0))
                     for p in counts for s in (64, 7)}
        for case, (arrs, sched) in cases.items():
            o_this, _ = run(mod, "this", *arrs, gposes, *sched, solver=solver,
                            **kw)
            o_other, _ = run(mod, "other", *arrs, gposes, *sched,
                             solver=solver, **kw)
            diff = same(o_this, o_other, SHARED_PLANES[mod])
            r["points"][case] = diff
            share = "" if mod is rollout3d else (
                f"; contact share "
                f"{contact_share(o_this, arrs[1].shape[1]):.5f}")
            print(f"  {case}: planes differing {diff}{share}", flush=True)
            if diff:
                raise SystemExit(f"{kname} {case}: the kernels differ on "
                                 f"{diff}")

        if mod is rollout3d:
            k2 = k2 or chip_smoke.k2_inputs(dev)
            arrs8 = rollout3d.scene_arrays_3d(k2["scenes8"], device=dev)
            arrs16 = rollout3d.scene_arrays_3d(k2["scenes16"], device=dev)
            poses, eposes = k2["poses"], k2["eposes"]
            rg = SIM.eval_regrasp_3d
            dg = (arrs8, poses, (SIM.steps_3d, 0, 0))
            ev = (arrs16, eposes, (SIM.eval_steps_3d, rg, rg))
        else:
            k1 = k1 or chip_smoke.k1_inputs(dev)
            arrs8 = rollout2d.scene_arrays(k1["scenes8"], device=dev)
            arrs16 = rollout2d.scene_arrays(k1["scenes16"], device=dev)
            poses, eposes = k1["poses"], k1["eposes"]
            rg = SIM.eval_regrasp_2d
            dg = (arrs8, poses, (SIM.steps_2d, 0, 0))
            ev = (arrs16, eposes, (SIM.eval_steps_2d, rg, rg))
        skw = dict(kw, solver=solver)
        r["datagen"], out = ab(f"{kname} datagen", mod,
                               (*dg[0], dg[1], *dg[2]), skw)
        if kname == "k2_newton_tol":
            # iterations a full step, and the fixed count of one iteration
            cf = out[9][:, ::128].double()
            ci = out[11][:, ::128].double()
            per = float((ci.sum() / cf.sum()).item())
            r["datagen_fixed"], _ = ab(f"{kname} datagen, fixed count 1",
                                       mod, (*dg[0], dg[1], *dg[2]),
                                       {"solver": solver})
            r["iters_per_full_step"] = per
            for which in ("this", "other"):
                t_tol = min(r["datagen"]["ms"][which])
                t_fix = min(r["datagen_fixed"]["ms"][which])
                b = (t_tol - t_fix) / (per - 1.0)
                r.setdefault("ms_per_iteration", {})[which] = b
                r.setdefault("ms_outside_iterations", {})[which] = t_fix - b
            print(f"  {kname}: {per:.3f} iterations a full step; T(n) = a + "
                  f"b n: b {r['ms_per_iteration']}, a "
                  f"{r['ms_outside_iterations']}", flush=True)
            continue
        r["verify"], _ = ab(f"{kname} verify", mod, (*ev[0], ev[1], *ev[2]),
                            skw)
        if mod is rollout3d:
            # the verification shape at 15 grippers: one wave of clusters
            a15 = [a[:15].contiguous() for a in ev[0]]
            r["verify_15"], _ = ab(f"{kname} verify at 15 grippers", mod,
                                   (*a15, ev[1], *ev[2]), skw)
        if solver == "jacobi":
            eng = engine3d if mod is rollout3d else engine2d
            old = eng.SOLVER_ITERS
            try:
                eng.SOLVER_ITERS = 0
                r["no_sweeps"], _ = ab(f"{kname} datagen, solver_iters 0",
                                       mod, (*dg[0], dg[1], *dg[2]), skw)
            finally:
                eng.SOLVER_ITERS = old

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({k: {s: v[s]["ms"] for s in v if isinstance(v[s], dict)
                          and "ms" in v[s]} for k, v in res.items()
                      if k in KERNELS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
