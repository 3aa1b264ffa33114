"""Drive the PyTorch port (dgdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit); build every hand-written
   kernel from the sources in this checkout (one ``nvcc`` per source, all
   started together, compiled anew even where an earlier build is at hand),
   report the build time and what ``ptxas -v`` says of each kernel
   (registers, at most 128 a thread; spills must be 0 bytes);
2. kernel K1 (rollout2d), datagen schedule at full size: 8 procedural
   grippers x 1 synthetic icon x the 9,000-pose grid (padded to 9,088) x
   200 steps, held against its plain PyTorch version on the card and against
   the golden outputs of the TPU kernel (tests/fixtures/rollout2d_golden.npz);
3. K1, eval schedule: 16 pairs x 360 orientations x 8,000 steps, regrasp and
   snapshot at 200, held against the plain version (snapshot tightly, the
   final pose statistically), with the host work of one such verification
   call (scene builds, upload, metrics) timed beside it;
4. the design loop through the normal entry point,
   ``dgdm_tpu_torch.cli.sample.main``: seeded full-width weights (UNet
   down_dims (128, 256); classifier width 256, 8 trunk layers, object_ch
   200) written with ``models/convert.py``, grid 360 x 5 x 5, B = 16, 5 DDIM
   steps, 2 synthetic test objects, objectives convergence, shift_up,
   rotate_clockwise, verification at 8,000 steps. The kernel launch counts
   are reset just before and read just after; every kernel of the path must
   have launched. One verification call of the loop (its shift_up samples
   of the first object) then runs once more, timed whole and K1 alone.
   Then the loop's objectives as the guided sampler weighs them
   (``GuidedSampler._objective_weights`` summed with the classifier's
   deltas of the loop's final samples over the 9,000-pose grid) must equal
   ``design/objectives.deltas_to_objective`` on the card, and that the same
   call on the CPU, each within 1e-6 relative, one line per objective;
5. kernel K2 (rollout3d), datagen schedule at full size: 8 grippers
   ``sample_gripper_3d(0..7)`` x the fixture object ``mug_small`` (one
   ``object_properties_3d`` shared by the block, 256 contact points, as
   ``datagen3d.generate_3d`` builds it) x the 9,000-pose grid (padded to
   9,088) x 800 steps, held against its plain version on the card and
   against the golden outputs of the TPU kernel
   (tests/fixtures/rollout3d_golden.npz) at both of its schedules, its
   share of the bound and its Newton iterations a full step printed beside
   PR 9's time (not measured in the run: commit 2164495, PERF.md section
   6), as in phases 6, 10 (a), (b) and 11 (c);
6. K2 at the verification shape of the 3D CLI: 16 grippers
   ``sample_gripper_3d(100..115)`` x mug_small x 45 orientations (padded to
   128) x 32,000 steps, regrasp and snapshot at 800, timed with CUDA events
   beside the host work of such a call. The snapshot must equal, bitwise,
   the kernel's own 800-step squeeze; kernel and plain version are held
   together on a shortened eval of 2,400 steps (snapshot by the bars, the
   final pose by corr >= 0.99 and 3-class agreement >= 0.99);
7. the 3D design loop through ``dgdm_tpu_torch.cli.sample.main
   --fingers_3d`` (the documented 3D command: ctrlpts 42, grid 45 x 5 x 5,
   sub_bs 512), seeded full-width weights (UNet down_dims (128, 256);
   ProfileForward3D width 256), B = 16, 5 DDIM steps, mug_small with a
   512-point cloud, objectives convergence, shift_up, rotate_clockwise,
   verification at the full 32,000 steps; K2's launch count is reset just
   before and read just after. One verification call of the loop (its
   shift_up samples) then runs once more, timed whole and K2 alone;
8. the cost of a settled-travel step (two block votes and one cluster
   barrier, almost nothing else): each kernel on a scene whose broad-phase
   bounds put the fingers out of reach, at two depths, the difference over
   the extra steps;
9. the data-to-checkpoint path through its entry points, in a temporary
   directory, the launch counts reset just before and read just after:
   (a) ``cli.datagen.main``, synthetic icons 0-3 x grippers 0-31 x the
   9,000-pose grid x 200 steps (one wave of 32 pairs an icon) and a
   validation set from icon 4: 5 K1 launches of 32 x 9,088; (b)
   ``cli.datagen3d.main`` on tests/fixtures/scanned_objects (mug_small) x
   grippers 0-15 in two blocks of 8 x 800 steps: 2 K2 launches of
   8 x 9,088; (c) ``cli.train_dynamics.main`` on (a)'s shards at full width
   (ProfileForward2D width 256, 8 trunk layers, object_ch 200), 4 pairs =
   36,000 rows a step, 2 epochs, bf16; (d) ``cli.train_diffusion.main``,
   20,480 procedural grippers, batch 2,048, 2 epochs, UNet down_dims
   (128, 256); (e) ``cli.sample.main`` on (c)'s ``ckpt/best`` and (d)'s
   ``ckpt/last`` directories: 1 synthetic object, shift_up, B = 16, grid
   360 x 5 x 5, 8,000-step verification. K1 must have launched >= 6 times
   and K2 >= 2 in the phase, 5 and 2 of them in the datagen CLIs. The
   pipelines' wall time is printed beside their summed kernel, bake and
   write times and the card's busy share; each drain of the 2D pipeline but
   the last must end while the next wave's kernel still runs (a result
   copy queued behind that kernel would hold it). Then, outside the counted
   run, one shard
   is held bitwise against ``rollout2d.profile_batch`` of its pair, one
   32-pair wave of K1 is timed alone, and one float32 (TF32 off) and one
   bfloat16 step of the classifier from the same weights and batch must
   agree in their loss within 1e-2 relative, and differ;
10. the JAX package's other solver configuration (``engine2d.SOLVER =
    "jacobi"``, restored after; phases 2-9 set "newton"): (a) K1's Jacobi
    instantiation at the datagen shape (8 x 9,088 x 200, icon 0, the
    FITTED_2D calibration), bitwise against its plain version and within the
    bars of tests/fixtures/rollout2d_jacobi_golden.npz, its bound from
    ``k1_jacobi_flops`` and its own step counters; then, launch counts reset
    just before and read just after, (b) the verification shape through
    ``sim_eval_batch_2d`` (16 x 360 x 8,000, regrasp and snapshot at 200)
    and (c) gradient design on the card (``design_gradient_2d`` with
    scripts/demo_grad_design.py's gripper, contour, objective and num_rot
    36, num_pairs 4, holdout_draws 8; depth cut to ``GRAD_DESIGN_ITERS`` = 4
    iterations, the demo runs 50): finite history and held-out values,
    iteration 0's candidate objectives within 2e-3 of the same call on the
    CPU, ``GRAD_BACKPROP_ITERS`` = 1 ``method="backprop"`` iteration with a
    finite non-zero gradient, and the start and designed grippers on 96
    orientations through the pure engine and K1 under both solvers. Outside
    the counted run: the 96-orientation K1 outputs of both solvers bitwise
    against their plain versions (the main path's own call, 2 x 128 x 200),
    (b)'s kernel timed alone, its 200-step snapshot bitwise against the
    kernel's own 200-step squeeze, the verify shape with its depth cut to
    ``K1_JACOBI_VERIFY_CUT`` = 400 steps (regrasp and snapshot at 200)
    bitwise against the plain version, and the pure engine's cost a step
    (ms, kernels, the card's busy share from ``torch.profiler``);
11. the JAX package's other 3D configuration (``engine3d.SOLVER3 =
    "jacobi"``, restored after), launch counts reset before each main-path
    call and read after: (a) K2's Jacobi instantiation through
    ``profile_pairs_3d`` at the datagen shape (8 x 9,088 x 800, the Jacobi
    calibration), held within the bars of
    tests/fixtures/rollout3d_jacobi_golden.npz and, with the depth cut to
    ``K2_JACOBI_DATAGEN_CUT`` = 400 of its 800 steps (past first contact; the
    full-solve counters printed), bitwise against its plain version; the
    kernel timed in 3 calls (their spread printed) beside the earlier
    design's time, its bound from ``k2_jacobi_flops`` and its share of it;
    (b) the verification shape through ``sim_eval_batch_3d`` (16 x 45 padded
    to 128 x 32,000, regrasp and snapshot at 800): one Jacobi launch, the
    kernel beside the earlier design's time and its share of the bound,
    again at 15 grippers (the 16th cluster's second wave) with the clusters
    resident, the snapshot bitwise against the kernel's own 800-step
    squeeze, the depth cut to ``K2_JACOBI_VERIFY_CUT`` = 850 steps bitwise
    against the plain version; (c) K2's adaptive-Newton instantiation
    (``newton_iters`` 6, ``newton_tol`` 1e-4) through
    ``rollout3d.profile_batch`` at the datagen shape, bitwise against its
    plain version with the depth cut to ``K2_NEWTON_TOL_CUT`` = 600 of 800
    steps (its full-solve steps begin at ~450-600) and within its
    golden fixture's bars, the iterations a full step per block beside the
    fixed count's; (d) the pure 3D engine on the card:
    ``profile_pairs_3d(use_pallas=False)`` on one 450-pose chunk of the grid
    x 8 pairs x 800 steps under Newton and Jacobi, held against K2 on the
    same pairs and poses (``engine_vs_kernel``), ``eval_rollout_batch_3d``
    at 16 x 45 with its depth cut to ``PURE3D_EVAL_CUT`` = 1,000 steps
    against K2's snapshot, ``rollout_trace3d`` (400 steps), each solver's
    cost a step (ms, kernels, busy share from ``torch.profiler``) and one
    step card vs CPU within 1e-5;
12. the multi-GPU layer (``dgdm_tpu_torch/parallel/``) and the flagship
    entry point: (a) ``graft_entry.entry()``, one guided-denoise step at the
    flagship shape (B 16, the 9,000-pose classifier gradient, UNet (128,
    256), classifier width 256, float32, TF32 off), ms a step over 20 calls
    with CUDA events, its output against the same step and weights on the
    CPU within 1e-5; (b) two ranks on cuda:0 over gloo (NCCL refuses two
    ranks on one device), started by ``parallel/launch.py``, each calling
    the CLIs' normal ``main(argv)``: ``cli.datagen`` (synthetic icons 0-1 x
    grippers 0-15 x the 9,000-pose grid x 200 steps, 8 pairs a rank a wave;
    the shards, written once by rank 0, bitwise the one-rank run's),
    ``cli.train_dynamics`` (full width, float32, 4 steps of 4 pairs) and
    ``cli.train_diffusion`` (UNet (128, 256), batch 2,048, 4 steps), both
    within the bars of tests/test_multichip.py of the one-rank run (losses
    2e-4 relative, parameters 5e-4; the diffusion's EMA),
    ``cli.sample`` on their checkpoints (grid 360 x 5 x 5 on sp = 2, B 16, 5
    DDIM steps, shift_up, 8,000-step verification split over both ranks;
    samples within 1e-5 of one rank on the same checkpoints), and
    ``sim_eval_batch_2d`` (16 x 360 x 8,000) and ``sim_eval_batch_3d`` (16 x
    mug_small x 45 x 2,400) on fixed samples, every metric bitwise the
    one-rank call's and K1 and K2 launched once by each rank; the
    one-rank references run in this process meanwhile; (c) a one-rank
    NCCL group: one all-reduce and one step of a DDP-wrapped
    ``DynamicsTrainer``. A rank that fails to start, launch or agree fails
    the phase;
13. the render path, the device part of ``cli.sample --render_video`` (whose
    writers, matplotlib and imageio, this host lacks): (a) the denoise
    trajectory at phase 4's shape (``train/generator.sample_trajectory``,
    B 16, UNet (128, 256), 5 DDIM steps, TF32 off), its last row bitwise
    ``generator.sample``'s and within 1e-5 of the CPU; (b) phase 4's 6
    design pairs (its best-success grippers, 3 objectives x 2 objects)
    through ``cli.sample.render_inputs`` as one batched 2D trace on the
    card, ``RENDER_2D_STEPS`` = 1,000 steps (cut from the CLI's 8,000),
    every 20, regrasp every 200: seconds, ms and CUDA kernels a step, the
    card's busy share (``torch.profiler``), the projected seconds at 8,000
    steps; the object turned; the first 400 steps of the first and last pair
    against each traced alone on the card, and against a CPU trace of the
    two, within 1e-4 rad and 1e-5 m (``scripts/probe_trace_chaos.py``); (c)
    their frames (50 x 128 x 128 x 3, uint8, the four colours, the object
    and both fingers in frame 0) and silhouettes on the host, timed; (d)
    phase 7's 3 design pairs as one batched 3D trace, 800 steps, every 20:
    unit quaternions, the first pair against itself alone within the same
    bars, finite scene points; (e) the files the writers make, and the CPU
    tests that write and check them. No kernel launches in this phase;
14. times and the summary, and ``chip_smoke total N s of 1,200 s`` (the
    time limit of the whole script, builds included; the depths cut for it
    are the constants under ``TIME_LIMIT_S``).

Each kernel has one thread layout (K1 16 threads a rollout, K2 32; a
128-pose group is a cluster of 8 blocks) and holds each thread's per-point
contact geometry in shared memory; the layout of the launch is printed per
shape. K1 is built in two instantiations (Newton, Jacobi), K2 in three
(Newton, Jacobi, Newton with ``newton_tol``); ``ptxas`` must report 0 bytes
of spills for each.

It then prints a ``{"kernels": [...]}`` line and, as its last line,
``{"ok": true, "device": {...}}``. It exits non-zero, without that line, if
CUDA is missing, a kernel does not build, launch or agree, or a phase fails.
Bars (as in tests/test_torch_rollout2d.py and test_torch_rollout3d.py):
>= 99% of lanes within 1e-3 and corr >= 0.999 for dtheta and dpos; step
counters equal per 128-pose block; for K2 also the tip-over validity equal.
Kernel against plain version, beyond those bars: every output plane bitwise
equal at the datagen shapes, at K1's verify shape (snapshot planes and
counters; the final pose by corr and classes) and at K2's 2,400-step cut.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# summary.json and the design loop's guided_report.json (gitignored)
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")
NAMES = ("dth", "dpx", "dpy", "fth", "fpx", "fpy", "cfull", "ccheap")
MUG = os.path.join(ROOT, "tests", "fixtures", "scanned_objects", "mug_small",
                   "model.obj")
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# the share of lanes whose tip-over flag a Jacobi rollout must share with the
# TPU kernel's, by schedule (the flag is the final one; see
# tests/test_torch_rollout3d_jacobi.py)
JACOBI_VALID_MIN = {"datagen": 0.95, "eval": 0.90}
# the script must end within 1,200 s on the card's host; the depths of these
# checks off the main path are cut to keep it near 75% of that (phases 1-7
# and 12 keep theirs). Each cut keeps first contact and full-solve steps, and
# each line it shortens prints the depth before and after.
TIME_LIMIT_S = 1200
GRAD_DESIGN_ITERS = 4          # phase 10 (c): of the demo's 50 (was 10)
GRAD_BACKPROP_ITERS = 1        # phase 10 (c): method="backprop" (was 2)
K1_JACOBI_VERIFY_CUT = 400     # phase 10: plain K1 Jacobi verify (was 1,000)
K2_JACOBI_DATAGEN_CUT = 400    # phase 11 (a): plain K2 Jacobi at the datagen
                               # shape, of 800 steps (was all 800): a Jacobi
                               # step is a full step from the first, and the
                               # grip begins after ~300
K2_NEWTON_TOL_CUT = 600        # phase 11 (c): plain K2 newton_tol there (was
                               # all 800): full-solve steps begin at ~450-600
                               # of the datagen grid's blocks
K2_JACOBI_VERIFY_CUT = 850     # phase 11 (b): plain K2 Jacobi verify, regrasp
                               # and snapshot at 800 (was 1,000)
PURE3D_EVAL_CUT = 1000         # phase 11 (d): eval_rollout_batch_3d (was
                               # 1,600)
PURE3D_TRACE_STEPS = 400       # phase 11 (d): rollout_trace3d (was 800)
RENDER_2D_STEPS = 1000         # phase 13 (b): the batched 2D trace, of the
                               # CLI's 8,000 (was 2,000); its first and last
                               # pair re-traced alone and on the CPU (was
                               # all 6); (d) the first 3D pair alone (was 3)


class PhaseClock:
    """Prints the seconds of each phase as it ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: dict = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        print(f"phase {name}: {now - self.t:.1f}s", flush=True)
        self.t = now


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def parity(out, ref, what: str, lane: int = 128) -> dict:
    """K1 bars on dtheta/dpos, counters equal per block; returns the stats."""
    stats = {}
    check(float(np.abs(ref["dth"]).max()) > 1e-2, f"{what}: reference did "
          "not move (max |dtheta| <= 1e-2)")
    for k in ("dth", "dpx", "dpy"):
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        check(np.isfinite(a).all(), f"{what}: non-finite {k}")
        frac = float(np.mean(np.abs(a - b) < 1e-3))
        corr = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
        stats[k] = {"frac_1e-3": frac, "corr": corr,
                    "max_abs_err": float(np.abs(a - b).max())}
        check(frac >= 0.99 and corr >= 0.999,
              f"{what}: {k} frac {frac:.5f} corr {corr:.6f}")
    for k in ("cfull", "ccheap", "citer"):
        if k in ref:
            check(np.array_equal(np.asarray(out[k])[:, ::lane],
                                 np.asarray(ref[k])[:, ::lane]),
                  f"{what}: {k} counters differ")
    if "valid" in ref:
        check(np.array_equal(out["valid"], ref["valid"]),
              f"{what}: tip-over validity differs")
    print(f"  {what}: " + ", ".join(
        f"{k} {v['frac_1e-3']:.5f} within 1e-3, corr {v['corr']:.6f}, "
        f"max err {v['max_abs_err']:.3g}" for k, v in stats.items()),
        flush=True)
    return stats


def timed_cuda(fn, reps: int, warm: bool = True):
    """Mean ms per call over ``reps`` calls, with CUDA events (after one
    untimed call unless ``warm`` is False)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def ptxas_report(name: str, lib, n_kernels: int = 1) -> dict:
    """Print registers and spill bytes of each kernel in the log of the
    build this run made (``nvcc -Xptxas -v``); spills must be 0. Returns
    (registers a thread, spill bytes stored and loaded) of each entry
    function, by its mangled name."""
    import re

    regs, spills, entries = [], [], []
    for line in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entries.append(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            print(f"  {name}: {line.strip()}", flush=True)
            spills.append(int(m.group(1)) + int(m.group(2)))
            check(m.group(1) == "0" and m.group(2) == "0",
                  f"{name} spills registers: {line.strip()}")
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(int(m.group(1)))
            print(f"  {name} ({entries[-1] if entries else '?'}): "
                  f"{line.strip()}", flush=True)
    check(len(regs) == n_kernels == len(entries) == len(spills),
          f"{name}: expected {n_kernels} kernel(s) in the build log, found "
          f"entries {entries}, registers {regs}, spills {spills}")
    return dict(zip(entries, zip(regs, spills)))


def bitwise(what: str, res, ref, planes) -> None:
    """Output planes ``planes`` of the kernel equal the plain version's bit
    for bit."""
    import torch

    bad = [k for k in planes if not torch.equal(res[k], ref[k])]
    check(not bad, f"{what}: planes {bad} differ from the plain version")
    print(f"  {what}: {len(planes)} planes bitwise equal to the plain "
          f"version", flush=True)


def chosen(mod) -> str:
    p = mod.LAST_PLAN
    check(p["threads_per_rollout"] == mod.THREADS_PER_ROLLOUT,
          f"launched {p}, not {mod.THREADS_PER_ROLLOUT} threads a rollout")
    return (f"G={p['threads_per_rollout']}, clusters of {p['cluster']} x "
            f"{p['threads']} threads ({p['max_active_clusters']} at a time), "
            f"{p['shared_bytes']} bytes of shared memory a block")


def travel_step_us(mod, arrs, poses, slots, counters,
                   depths=(8000, 40000)) -> dict:
    """Cost of one settled-travel step: the scene's broad-phase bounds
    (scalar slots ``slots``) are pushed out of the fingers' reach, so after
    the object has come to rest every step takes the travel path (the group
    votes and the servo update). Two depths; the difference over the extra
    steps. The step counters (output planes ``counters``: full, cheap) must
    show that both runs solved equally often."""
    import torch

    scal = arrs[-1].clone()
    scal[:, 0, slots[0]] = -1e3
    scal[:, 0, slots[1]] = 1e3
    arrs = tuple(arrs[:-1]) + (scal,)
    ms, solves = [], []
    for steps in depths:
        t, out = timed_cuda(lambda: mod.rollout_cuda(*arrs, poses, steps, 0,
                                                     0), reps=2)
        ms.append(t)
        solves.append(float(sum(out[k].amax() for k in counters)))
    check(solves[0] == solves[1] < depths[0] / 2,
          f"travel timing: solve steps {solves} differ between the depths")
    return {"us_per_step": 1e3 * (ms[1] - ms[0]) / (depths[1] - depths[0]),
            "ms": ms, "depths": list(depths), "solve_steps": solves,
            "plan": dict(mod.LAST_PLAN)}


def k1_flops(p: int, s: int, steps: int, cfull, ccheap) -> float:
    """Float32 operations the rollouts of this run need, counted by hand
    from the formulas of dgdm_tpu_torch/sim/rollout2d_ref.py: per lane, a
    full-solve step costs the contact geometry once per point plus 3 Newton
    iterations (gradient, Hessian and 3 line-search energies over points and
    supports, a 5x5 Cholesky); a cheap step 2 iterations over the supports;
    a travel step the servo update; every step the gate. ``cfull``/
    ``ccheap`` are this run's per-lane step counts (data dependent)."""
    full = p * 123 + 3 * (p * 221 + s * 92 + 130) + s * 13 + 50
    cheap = s * 13 + 2 * (s * 88 + 60)
    cf, cc = np.asarray(cfull, np.float64), np.asarray(ccheap, np.float64)
    travel = steps - cf - cc
    return float(np.sum(cf * full + cc * cheap + travel * 15 + steps * 20))


def k1_bytes(b: int, p: int, s: int, n: int) -> int:
    return 4 * (b * (2 * 6 * 4 + 2 * p + 4 * s + 16) + 3 * n + 9 * b * n)


def k2_view(raw, poses) -> dict:
    """Raw K2 outputs (12 tensors) -> numpy dict of the snapshot dtheta,
    dpx, dpy, the final theta and origin, validity and the counters."""
    from dgdm_tpu_torch.sim.rollout3d_ref import readout

    dth, sdpos, fth, valid, fpos = readout(*raw[:9], poses)
    out = {"dth": dth, "dpx": sdpos[..., 0], "dpy": sdpos[..., 1],
           "fth": fth, "fpx": fpos[..., 0], "fpy": fpos[..., 1],
           "valid": valid, "cfull": raw[9], "ccheap": raw[10],
           "citer": raw[11]}
    return {k: v.cpu().numpy() for k, v in out.items()}


def k2_flops(p: int, steps: int, cfull, ccheap, citer) -> float:
    """Operations the 3D rollouts of this run need, counted by hand from
    the formulas of dgdm_tpu_torch/sim/rollout3d_ref.py, per lane: a normal
    step first spans the points' wy (5 per point); a full-solve step costs
    the contact geometry once per point (plane rows ~39, finger narrow
    phase with two bivariate Horner evaluations ~200) and per Newton
    iteration ~760 per point (gradient, 62 Hessian sums, 3 line-search
    energies, the float64 accumulations counted as one operation each) plus
    an 8x8 Cholesky solve (~400); a cheap step the plane rows (~39 per
    point) and 3 iterations of ~175 per point plus a 6x6 solve (~200); a
    travel step the servo update (15); every step the gates (25).
    ``cfull``/``ccheap``/``citer`` are this run's per-lane counts."""
    cf, cc, ci = (np.asarray(x, np.float64) for x in (cfull, ccheap, citer))
    travel = steps - cf - cc
    return float(np.sum(cf * (p * (5 + 239) + 100) + ci * (p * 760 + 400)
                        + cc * (p * (5 + 39 + 3 * 175) + 3 * 200 + 100)
                        + travel * 15 + steps * 25))


def k2_bytes(b: int, p: int, n: int) -> int:
    return 4 * (b * (2 * 24 * 12 + 4 * p + 32) + 3 * n + 12 * b * n)


def pr9(ms: str) -> str:
    """A time of PR 9's kernel, printed beside this run's: not measured in
    this run."""
    return (f"not measured in this run: PR 9's kernel, commit 2164495, {ms} "
            f"in PERF.md section 6")


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def objective_check(unet_path: str, cls_path: str, save_dir: str, oid,
                    contour: np.ndarray, dev) -> dict:
    """Phase 4: the design loop's objectives as the guided sampler weighs
    them (``GuidedSampler._objective_weights`` summed with the deltas;
    'rotate' squares component 0) against
    ``design/objectives.deltas_to_objective`` on the card, and that against
    the same call on the CPU, each within 1e-6 relative to the largest
    entry. The deltas: the loop's full-width classifier on the loop's final
    samples of each objective (object ``oid``) over the full 360 x 5 x 5
    pose grid at t = 0; the convergence centers found as the loop finds
    them (from the unguided samples of its noise)."""
    import torch

    from dgdm_tpu_torch.core.config import NORM
    from dgdm_tpu_torch.design.guidance import GuidedSampler
    from dgdm_tpu_torch.design.objectives import deltas_to_objective
    from dgdm_tpu_torch.models import convert
    from dgdm_tpu_torch.train import generator

    grid, num_pos, b = 360, 5, 16
    sampler = GuidedSampler(
        convert.load_model(unet_path, "unet", input_dim=1),
        convert.load_model(cls_path, "profile2d", params_ch=14,
                           object_ch=200),
        grid_size=grid, num_pos=num_pos, device=dev)
    obj_flat = torch.as_tensor(contour.reshape(-1) / NORM.object_extent_2d,
                               dtype=torch.float32, device=dev)
    noise = torch.as_tensor(np.random.RandomState(0).randn(b, 14, 1)
                            .astype(np.float32), device=dev)
    unguided = generator.sample(sampler.unet, noise, 15, 5)
    centers = sampler.find_convergence_centers(
        unguided, obj_flat, NORM.threshold_std(False)[0])
    poses = sampler._poses((-1.0, 1.0))
    n = poses.shape[0]
    check(n == 9000, f"the full pose grid: {n} poses")
    feat = sampler._encode_object(obj_flat)
    out = {}
    for objective in ("convergence", "shift_up", "rotate_clockwise"):
        x = torch.as_tensor(np.load(os.path.join(
            save_dir, f"samples_{objective}_{oid}.npy")), device=dev)[..., 0]
        with torch.no_grad():
            deltas = sampler.classifier.trunk(
                x[None].expand(n, b, x.shape[-1]).reshape(n * b, -1),
                poses[:, 0:1].repeat_interleave(b, dim=0),
                poses[:, 1:3].repeat_interleave(b, dim=0),
                torch.zeros(n * b, device=dev), feat[None]).reshape(n, b, 3)
        check(bool(torch.isfinite(deltas).all()), f"{objective}: finite "
              f"deltas")
        w, rotate_sq = sampler._objective_weights(objective, centers, b)
        via_w = (deltas[..., 0] ** 2 if rotate_sq
                 else (w * deltas).sum(-1)).T                     # (B, N)
        kw = dict(grid_size=grid, num_pos=num_pos)
        card = deltas_to_objective(deltas.permute(1, 0, 2), objective,
                                   centers=centers, **kw)
        cpu = deltas_to_objective(deltas.permute(1, 0, 2).cpu(), objective,
                                  centers=centers.cpu(), **kw)
        check(card.shape == via_w.shape == (b, n)
              and card.device == deltas.device,
              f"{objective}: shapes {tuple(card.shape)}, "
              f"{tuple(via_w.shape)}")
        scale = max(float(card.abs().max()), 1e-30)
        err_w = float((via_w - card).abs().max()) / scale
        err_cpu = float((card.cpu() - cpu).abs().max()) / scale
        print(f"  objective {objective} over {b} samples x {n} poses: the "
              f"sampler's weights vs deltas_to_objective on the card "
              f"{err_w:.3g}, card vs CPU {err_cpu:.3g} (relative, bar 1e-6)",
              flush=True)
        check(err_w <= 1e-6 and err_cpu <= 1e-6,
              f"{objective}: the sampler's objective differs from "
              f"deltas_to_objective ({err_w:.3g}, card vs CPU {err_cpu:.3g})")
        out[objective] = {"weights_vs_function": err_w,
                          "card_vs_cpu": err_cpu}
    return out


def phases_3d(dev, clock: PhaseClock) -> dict:
    """Phases 5-7: kernel K2 at the datagen and verification shapes, and the
    3D design loop. Returns the numbers for the summary."""
    import torch

    from dgdm_tpu_torch.cli import sample as sample_cli
    from dgdm_tpu_torch.core.config import NORM, SIM
    from dgdm_tpu_torch.eval.metrics import three_class
    from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
    from dgdm_tpu_torch.geom import mesh3d
    from dgdm_tpu_torch.geom.fingers import denormalize_y, sample_gripper_3d
    from dgdm_tpu_torch.models import convert
    from dgdm_tpu_torch.models.profile3d import ProfileForward3D
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
    from dgdm_tpu_torch.sim import datagen, engine2d, engine3d, rollout3d
    from dgdm_tpu_torch.sim.rollout3d_ref import OUT_NAMES, profile_batch_ref

    verts, faces = mesh3d.load_obj(MUG)
    out: dict = {}

    # ---- 5. K2 datagen schedule at full size ------------------------------
    props = engine3d.object_properties_3d(verts, faces)
    scenes8 = datagen.stack_scenes([
        engine3d.make_scene(*sample_gripper_3d(i), verts, faces,
                            obj_props=props) for i in range(8)])
    arrs8 = rollout3d.scene_arrays_3d(scenes8, device=dev)
    check(arrs8[1].shape == (8, 256, 4), "256 contact points per pair")
    poses = torch.as_tensor(datagen.pad_poses(engine2d.pose_grid()),
                            device=dev)
    dg_ms, dout = timed_cuda(lambda: rollout3d.rollout(*arrs8, poses), reps=2)
    print(f"  K2 datagen 8x9088x800: {chosen(rollout3d)}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dref = profile_batch_ref(*arrs8, poses)
    torch.cuda.synchronize()
    dg_plain_ms = 1e3 * (time.perf_counter() - t0)
    bitwise("K2 datagen 8x9088x800", dout, dref, range(12))
    do, dr = k2_view(dout, poses), k2_view(dref, poses)
    for k, v in do.items():
        check(v.shape == (8, 9088), f"datagen {k} shape")
    dg_stats = parity(do, dr, "K2 datagen 8x9088x800, kernel vs plain")
    dg_exact = float(np.mean(do["dth"] == dr["dth"]))
    dg_bound, dg_bound_by = bound_ms(
        k2_flops(256, SIM.steps_3d, dout[9].cpu(), dout[10].cpu(),
                 dout[11].cpu()), k2_bytes(8, 256, 9088))
    print(f"  kernel {dg_ms:.1f} ms/call ({8 * 9000 / dg_ms * 1e3:,.0f} "
          f"rollouts/s of the 9,000-pose grid; {pr9('660.7 ms')}), plain "
          f"{dg_plain_ms:.0f} ms; bound {dg_bound:.2f} ms ({dg_bound_by}), "
          f"{100.0 * dg_bound / dg_ms:.1f}% of it; dtheta bitwise equal on "
          f"{dg_exact:.4f} of lanes; valid {do['valid'].mean():.4f}; "
          f"full/cheap steps per block {do['cfull'][:, ::128].mean():.1f}/"
          f"{do['ccheap'][:, ::128].mean():.1f} of 800; Newton iterations a "
          f"full step {float(dout[11].sum() / dout[9].sum()):.2f}",
          flush=True)
    gold = np.load(os.path.join(ROOT, "tests", "fixtures",
                                "rollout3d_golden.npz"))
    garrs = [torch.as_tensor(gold[k], device=dev)
             for k in ("coefs", "points", "scalars")]
    gposes = torch.as_tensor(gold["poses"], device=dev)
    gold_stats = {}
    for sched in ("datagen", "eval"):
        steps, rg, snap = (int(v) for v in gold[f"{sched}_schedule"])
        g_out = rollout3d.rollout(*garrs, gposes, steps=steps,
                                  regrasp_every=rg, snapshot_step=snap)
        g_ref = [torch.as_tensor(gold[f"{sched}_{k}"], device=dev)
                 for k in OUT_NAMES]
        gold_stats[sched] = parity(
            k2_view(g_out, gposes), k2_view(g_ref, gposes),
            f"K2 golden {sched} ({steps} steps), kernel vs TPU kernel")
    out["datagen"] = {"kernel_ms": dg_ms, "plain_ms": dg_plain_ms,
                      "bound_ms": dg_bound, "bound_by": dg_bound_by,
                      "rollouts_per_s": 8 * 9000 / dg_ms * 1e3,
                      "parity": dg_stats, "dtheta_bitwise_equal": dg_exact,
                      "full_steps_per_block": float(
                          do["cfull"][:, ::128].mean()),
                      "cheap_steps_per_block": float(
                          do["ccheap"][:, ::128].mean()),
                      "golden": gold_stats}

    clock.done("5")
    # ---- 6. K2 at the verification shape ----------------------------------
    # host work of one verification call (object properties, scene builds
    # of 16 new grippers, their upload), timed beside K2
    t0 = time.perf_counter()
    props = engine3d.object_properties_3d(verts, faces)
    scenes16 = datagen.stack_scenes([
        engine3d.make_scene(*sample_gripper_3d(100 + i), verts, faces,
                            obj_props=props) for i in range(16)])
    arrs16 = rollout3d.scene_arrays_3d(scenes16, device=dev)
    torch.cuda.synchronize()
    host_scene_s = time.perf_counter() - t0
    nrot = 45
    thetas = (np.linspace(-1.0, 1.0, nrot) * np.pi + np.pi).astype(np.float32)
    th_p = datagen.pad_poses(thetas[:, None])[:, 0]
    eposes = torch.as_tensor(
        np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1),
        device=dev)
    ekw = dict(regrasp_every=SIM.eval_regrasp_3d,
               snapshot_step=SIM.eval_regrasp_3d)
    ev_ms, eout = timed_cuda(lambda: rollout3d.rollout(
        *arrs16, eposes, steps=SIM.eval_steps_3d, **ekw), reps=1, warm=False)
    ev_plan = dict(rollout3d.LAST_PLAN)
    print(f"  K2 verify 16x128x32000: {chosen(rollout3d)}", flush=True)
    eo = k2_view(eout, eposes)
    t0 = time.perf_counter()
    classes = [[three_class(eo["dth"][i, :nrot], NORM.threshold_3d[0]),
                three_class(eo["dpx"][i, :nrot], NORM.threshold_3d[1]),
                three_class(eo["dpy"][i, :nrot], NORM.threshold_3d[2])]
               for i in range(16)]
    host_metrics_s = time.perf_counter() - t0
    check(len(classes) == 16 and np.isfinite(eo["fth"]).all(),
          "verify: finite final poses")
    # the snapshot at 800 is the kernel's own 800-step squeeze, bitwise
    sq = rollout3d.rollout(*arrs16, eposes, steps=SIM.eval_regrasp_3d)
    for a in range(5, 9):
        check(torch.equal(eout[a], sq[a]),
              f"verify: snapshot {OUT_NAMES[a]} differs from the 800-step "
              f"squeeze's")
    ev_full = float(eo["cfull"][:, ::128].mean())
    ev_cheap = float(eo["ccheap"][:, ::128].mean())
    ev_flops = k2_flops(256, SIM.eval_steps_3d, eout[9].cpu(), eout[10].cpu(),
                        eout[11].cpu())
    ev_bound, ev_bound_by = bound_ms(ev_flops, k2_bytes(16, 256, 128))
    print(f"  K2 verify 16x128x32000: kernel {ev_ms:.0f} ms/call "
          f"({pr9('750.4 ms')}); snapshot bitwise equal to the 800-step "
          f"squeeze; full/cheap steps per block {ev_full:.0f}/{ev_cheap:.0f} "
          f"of 32,000; valid {eo['valid'][:, :nrot].mean():.4f}; bound "
          f"{ev_bound:.2f} ms ({ev_bound_by}), "
          f"{100.0 * ev_bound / ev_ms:.1f}% of it; Newton iterations a full "
          f"step {float(eout[11].sum() / eout[9].sum()):.2f}; host per call: "
          f"scene build + upload {host_scene_s:.2f}s, classes "
          f"{host_metrics_s:.3f}s", flush=True)

    # shortened eval: kernel vs plain over 2,400 steps
    skw = dict(steps=3 * SIM.eval_regrasp_3d, **ekw)
    se_ms, sout = timed_cuda(lambda: rollout3d.rollout(
        *arrs16, eposes, **skw), reps=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sref = profile_batch_ref(*arrs16, eposes, **skw)
    torch.cuda.synchronize()
    se_plain_ms = 1e3 * (time.perf_counter() - t0)
    bitwise("K2 verify cut 16x128x2400", sout, sref, range(12))
    so = {k: v[:, :nrot] for k, v in k2_view(sout, eposes).items()}
    sr = {k: v[:, :nrot] for k, v in k2_view(sref, eposes).items()}
    se_stats = parity(so, sr, "K2 eval 16x128x2400 snapshot, kernel vs plain")
    fcorr = float(np.corrcoef(so["fth"].ravel(), sr["fth"].ravel())[0, 1])
    agree = [float(np.mean(three_class(so[k], t) == three_class(sr[k], t)))
             for k, t in zip(("dth", "dpx", "dpy"), NORM.threshold_3d)]
    final_err = float(np.abs(so["fth"] - sr["fth"]).max())
    print(f"  final pose after 2,400 steps: corr(final theta) {fcorr:.6f}, "
          f"max |diff| {final_err:.3g}; 3-class agreement min "
          f"{min(agree):.4f}; kernel {se_ms:.0f} ms, plain {se_plain_ms:.0f} "
          f"ms", flush=True)
    check(fcorr >= 0.99 and min(agree) >= 0.99, "eval final/profile classes")
    se_bound, se_bound_by = bound_ms(
        k2_flops(256, skw["steps"], sout[9].cpu(), sout[10].cpu(),
                 sout[11].cpu()), k2_bytes(16, 256, 128))
    # padded lanes: 83 of each group's 128 rollouts repeat the last pose
    pad_share = 1.0 - nrot / eposes.shape[0]
    out["verify"] = {"kernel_ms": ev_ms, "flops": ev_flops, "plan": ev_plan,
                     "padded_share": pad_share,
                     "bound_ms": ev_bound, "bound_by": ev_bound_by,
                     "full_steps_per_block": ev_full,
                     "cheap_steps_per_block": ev_cheap,
                     "host_scene_s": host_scene_s,
                     "host_metrics_s": host_metrics_s}
    out["short_eval"] = {"kernel_ms": se_ms, "plain_ms": se_plain_ms,
                         "bound_ms": se_bound, "bound_by": se_bound_by,
                         "parity": se_stats, "final_theta_corr": fcorr,
                         "class_agreement_min": min(agree),
                         "max_abs_err_final": final_err}
    out["max_abs_err"] = max(v["max_abs_err"] for st in (dg_stats, se_stats)
                             for v in st.values())

    clock.done("6")
    # ---- 7. the 3D design loop through cli.sample.main --------------------
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        unet_cfg = {"down_dims": [128, 256]}
        cls_cfg = {"width": 256, "params_ch": 42}
        gpath, dpath = (os.path.join(tmp, f) for f in ("unet.npz", "dyn.npz"))
        convert.save_npz(gpath, ConditionalUnet1D(**unet_cfg).state_dict(),
                         unet_cfg)
        convert.save_npz(dpath, ProfileForward3D(**cls_cfg).state_dict(),
                         cls_cfg)
        save_dir = os.path.join(tmp, "guided3d")
        for k in rollout3d.KERNEL_LAUNCHES:
            rollout3d.KERNEL_LAUNCHES[k] = 0
        t0 = time.perf_counter()
        report = sample_cli.main([
            "--fingers_3d", "--ctrlpts_dim", "42", "--grid_size", "45",
            "--num_pos", "5", "--sub_bs", "512",
            "--diffusion_checkpoint_path", gpath, "--checkpoint_path", dpath,
            "--save_dir", save_dir, "--batch_size", "16",
            "--num_inference_steps", "5",
            "--object_dir", os.path.join(ROOT, "tests", "fixtures",
                                         "scanned_objects"),
            "--object_max_num_vertices", "512",
            "--objectives", "convergence,shift_up,rotate_clockwise",
            "--device", "cuda",
        ])
        torch.cuda.synchronize()
        design_s = time.perf_counter() - t0
        launches = dict(rollout3d.KERNEL_LAUNCHES)
        n_samples = 0
        for name in sorted(os.listdir(save_dir)):
            if name.startswith("samples_") and name.endswith(".npy"):
                smp = np.load(os.path.join(save_dir, name))
                check(smp.shape == (16, 42, 1) and np.isfinite(smp).all(),
                      f"{name}: finite (16, 42, 1) samples")
                n_samples += 1
        check(n_samples == 5, f"5 sample files, found {n_samples}")
        shutil.copy(os.path.join(save_dir, "guided_report.json"),
                    os.path.join(OUT_DIR, "guided_report_3d.json"))
        # phase 13 renders the loop's best-success grippers
        render_pairs_3d = design_pairs(report, save_dir,
                                       {"mug_small": (verts, faces)}, True)
        check(len(render_pairs_3d) == 3,
              f"3 design pairs, found {len(render_pairs_3d)}")
        # where one verification call of the loop spends its time: the
        # guided shift_up samples once more, the whole call on the host
        # clock, and its K2 launch with CUDA events
        samp = np.load(os.path.join(save_dir,
                                    "samples_shift_up_mug_small.npy"))[..., 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim_eval_batch_3d(samp, [(verts, faces)], num_rot=nrot, device=dev)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    y = denormalize_y(samp, fingers_3d=True)
    arrs_s = rollout3d.scene_arrays_3d(datagen.stack_scenes([
        engine3d.make_scene(yi[:21], yi[21:], verts, faces, obj_props=props)
        for yi in y]), device=dev)
    call_k_ms, sout = timed_cuda(lambda: rollout3d.rollout(
        *arrs_s, eposes, steps=SIM.eval_steps_3d, **ekw), reps=1, warm=False)
    call_full = float(sout[9][:, ::128].mean())
    check(launches["rollout3d"] > 0,
          "kernel rollout3d was not launched on the 3D design path")
    print(f"3D design loop: {design_s:.1f}s end to end (sweep "
          f"{report['design_sweep']['seconds']:.2f}s for "
          f"{report['design_sweep']['pairs']} pairs, verification "
          f"{report['verification']['seconds']:.1f}s); kernel launches "
          f"{launches}", flush=True)
    print(f"  one verification call of the loop (shift_up samples, "
          f"mug_small): {call_s:.2f}s on the host clock (0.92 s in the "
          f"earlier run PERF.md records; the kernel's path bakes no height "
          f"grid), K2 "
          f"{call_k_ms:.0f} ms of it, the host {call_s - call_k_ms / 1e3:.2f}"
          f"s; full-solve steps per block {call_full:.0f} of 32,000",
          flush=True)
    clock.done("7")
    out["travel"] = travel_step_us(rollout3d, arrs16, eposes, (25, 26),
                                   (9, 10))
    out.update(render_pairs=render_pairs_3d,
               design_loop_s=design_s, launches=launches,
               design_sweep_s=report["design_sweep"]["seconds"],
               verification_s=report["verification"]["seconds"],
               design_call={"seconds": call_s, "kernel_ms": call_k_ms,
                            "full_steps_per_block": call_full})
    return out


def k1_jacobi_flops(p: int, s: int, steps: int, cfull, ccheap) -> float:
    """Float32 operations the Jacobi rollouts of this run need, counted by
    hand from ``jacobi_step`` of dgdm_tpu_torch/sim/rollout2d_ref.py, per
    lane: a full step (every normal Jacobi step) costs the contact geometry
    of every point (~110) and its elastic impulse under the energy clamp
    (~79 over three passes), then 6 iterations of ~55 a contour point and
    ~59 a support point (planar friction ~45, torsion ~14), and ~300 of
    lane-level updates and point-sum additions; a travel step the servo
    update (15); every step the gate (20). ``cfull``/``ccheap`` are this
    run's per-lane counts (ccheap is 0 for Jacobi)."""
    full = p * 189 + 6 * (p * 55 + s * 59) + 300
    cf, cc = np.asarray(cfull, np.float64), np.asarray(ccheap, np.float64)
    travel = steps - cf - cc
    return float(np.sum(cf * full + travel * 15 + steps * 20))


def k1_inputs(dev) -> dict:
    """Phase 10's inputs of K1 (scripts/probe_kernel_ab.py reads them too):
    synthetic icon 0's contour with grippers 0-7 as scenes over the
    9,088-pose grid (the datagen shape), and grippers 100-115 normalised
    (``pts``) and, from those, as scenes, with 360 orientations padded to
    384 poses (the verification shape). Poses lie on
    ``dev``; the scenes stay on the host, so that the caller builds their
    arrays (``rollout2d.scene_arrays``, which takes the calibration of
    ``engine2d.SOLVER``) under the solver it sets."""
    import torch

    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.geom.fingers import (denormalize_y, normalize_y,
                                             sample_gripper_2d)
    from dgdm_tpu_torch.sim import datagen, engine2d

    contour = extract_contours(synthetic_icon(0))
    scenes8 = datagen.stack_scenes(
        [engine2d.make_scene(*sample_gripper_2d(i), contour)
         for i in range(8)])
    ys = np.stack([np.concatenate(sample_gripper_2d(100 + i))
                   for i in range(16)])
    pts = normalize_y(ys)
    scenes16 = datagen.stack_scenes(
        [engine2d.make_scene(yi[:7], yi[7:], contour)
         for yi in denormalize_y(pts)])
    thetas = (np.linspace(-1.0, 1.0, 360) * np.pi + np.pi).astype(
        np.float32)
    th_p = datagen.pad_poses(thetas[:, None])[:, 0]
    eposes = np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1)
    return {"contour": contour, "scenes8": scenes8,
            "poses": torch.as_tensor(
                datagen.pad_poses(engine2d.pose_grid()), device=dev),
            "pts": pts, "scenes16": scenes16,
            "eposes": torch.as_tensor(eposes, device=dev)}


def demo_contour() -> np.ndarray:
    """The object of scripts/demo_grad_design.py (100 points)."""
    ang = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    rad = 0.035 * (1 + 0.2 * np.sin(3 * ang) + 0.08 * np.cos(5 * ang))
    return np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)


def engine_step_cost(dev, scene, y) -> dict:
    """The pure engine's cost on the card at one smoothed iteration's batch
    (8 candidates x 36 orientations), under the current engine2d.SOLVER: ms
    a step, and from a torch.profiler window of 10 steps the CUDA kernels
    a step and the card's busy share (their summed device time over the
    window's wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dgdm_tpu_torch.design import graddesign
    from dgdm_tpu_torch.sim import engine2d

    xy = torch.zeros(8, 36, 2, device=dev)
    cands = y.expand(8, 2, 7)
    kw = dict(objective="rotate_clockwise")
    ms, _ = timed_cuda(lambda: graddesign.mean_objective(
        cands, scene, xy, steps=50, **kw), reps=1)
    sc = graddesign.scene_with_y(scene, cands[:, 0, None], cands[:, 1, None])
    th = torch.linspace(0, 2 * np.pi, 37, device=dev)[:36]
    pose = torch.cat([xy, th.expand(8, 36)[..., None]], -1)
    state = engine2d.init_state(sc, pose)
    ctrl = torch.tensor([0.2, -0.2], device=dev)
    for _ in range(150):        # into the squeeze, where the fingers touch
        state = engine2d.step(sc, state, ctrl)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            state = engine2d.step(sc, state, ctrl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        # the kernels themselves (as scripts/profile_train_step.py reads
        # them)
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        busy_us += dev_us
        launches += e.count
    return {"ms_per_step": ms / 50, "kernels_per_step": launches / 10,
            "busy_share": busy_us / (1e6 * wall) if busy_us else None,
            "profiled_ms_per_step": 1e3 * wall / 10}


def phase_jacobi_design(dev) -> dict:
    """Phase 10, under engine2d.SOLVER = "jacobi" (restored after): (a) K1's
    Jacobi branch at the datagen shape, held to its plain version and its
    golden fixture; (b) at the verification shape through
    ``sim_eval_batch_2d``; (c) gradient design on the card. The launch
    counts are reset before (b) and read after (c). Returns the numbers for
    the summary."""
    import torch

    from dgdm_tpu_torch.core.config import GRIPPER_2D, SIM
    from dgdm_tpu_torch.design import graddesign
    from dgdm_tpu_torch.eval.simeval import sim_eval_batch_2d
    from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
    from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d
    from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref
    from dgdm_tpu_torch.sim.types import to_device

    out: dict = {}
    old_solver = engine2d.SOLVER
    engine2d.SOLVER = "jacobi"
    try:
        t_phase = time.perf_counter()
        # ---- (a) datagen shape: 8 x 9,088 x 200, icon 0, FITTED_2D -------
        inp = k1_inputs(dev)
        contour, poses = inp["contour"], inp["poses"]
        arrs8 = rollout2d.scene_arrays(inp["scenes8"], device=dev)
        check(float(arrs8[3][0, 0, 9])
              == float(np.float32(engine2d.FITTED_2D["k_contact"])),
              "the Jacobi calibration (FITTED_2D) in the scalar slots")
        dg_ms, res = timed_cuda(lambda: rollout2d.rollout(*arrs8, poses),
                                reps=5)
        dg_plan = dict(rollout2d.LAST_PLAN)
        plan = chosen(rollout2d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = profile_batch_ref(*arrs8, poses,
                                sum_group=rollout2d.THREADS_PER_ROLLOUT)
        torch.cuda.synchronize()
        dg_plain_ms = 1e3 * (time.perf_counter() - t0)
        bitwise("K1 Jacobi datagen 8x9088x200", res, ref, range(9))
        res_np = {k: v.cpu().numpy() for k, v in zip(NAMES, res)}
        check((res_np["ccheap"] == 0).all(), "Jacobi: no cheap steps")
        stats = parity(res_np, {k: v.cpu().numpy()
                                for k, v in zip(NAMES, ref)},
                       "Jacobi datagen 8x9088x200, kernel vs plain")
        s_ = arrs8[2].shape[1]
        dg_bound, dg_bound_by = bound_ms(
            k1_jacobi_flops(contour.shape[0], s_, SIM.steps_2d,
                            res_np["cfull"], res_np["ccheap"]),
            k1_bytes(8, contour.shape[0], s_, 9088))
        print(f"  K1 Jacobi datagen 8x9088x200: {plan}; kernel {dg_ms:.2f} "
              f"ms/call ({pr9('85.3 ms')}), plain {dg_plain_ms:.0f} ms, bound "
              f"{dg_bound:.2f} ms ({dg_bound_by}), "
              f"{100.0 * dg_bound / dg_ms:.1f}% of it; full steps per block "
              f"{res_np['cfull'][:, ::128].mean():.1f} of 200", flush=True)
        gold = np.load(os.path.join(ROOT, "tests", "fixtures",
                                    "rollout2d_jacobi_golden.npz"))
        check(str(gold["solver"]) == "jacobi", "Jacobi golden fixture")
        garrs = [torch.as_tensor(gold[k], device=dev)
                 for k in ("coefs", "contour", "support", "scalars")]
        gposes = torch.as_tensor(gold["poses"], device=dev)
        for sched in ("datagen", "eval"):
            steps, rg, snap = (int(v) for v in gold[f"{sched}_schedule"])
            g_out = rollout2d.rollout(*garrs, gposes, steps=steps,
                                      regrasp_every=rg, snapshot_step=snap)
            parity({k: v.cpu().numpy() for k, v in zip(NAMES, g_out)},
                   {k: gold[f"{sched}_{k}"] for k in NAMES},
                   f"Jacobi golden {sched} ({steps} steps), kernel vs TPU "
                   f"kernel")

        # ---- the main path: (b) and (c), launches counted ----------------
        for k in rollout2d.KERNEL_LAUNCHES:
            rollout2d.KERNEL_LAUNCHES[k] = 0
        # (b) verification through sim_eval_batch_2d: 16 x 360 (384) x 8,000
        pts = inp["pts"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = sim_eval_batch_2d(pts, [contour], device=dev)
        torch.cuda.synchronize()
        ev_call_s = time.perf_counter() - t0
        check(len(metrics) == 16 and all(
            np.isfinite(m["delta_theta"]).all()
            and np.isfinite(m["final_pos"]).all() for m in metrics),
            "sim_eval_batch_2d: 16 finite metric dicts")
        b_launches = dict(rollout2d.KERNEL_LAUNCHES)
        check(b_launches["rollout2d_jacobi"] == 1
              and b_launches["rollout2d"] == 0,
              f"verification launched the Jacobi branch once: {b_launches}")

        # (c) gradient design on the card: the demo's protocol, depth cut
        gcontour = demo_contour()
        yl0, yr0 = sample_gripper_2d(0)
        gkw = dict(objective="rotate_clockwise", num_rot=36, steps=200,
                   num_pairs=4, holdout_draws=8)
        iters = GRAD_DESIGN_ITERS
        print(f"  gradient design (scripts/demo_grad_design.py's protocol: "
              f"sample_gripper_2d(0), its contour, {gkw}); depth cut: "
              f"{iters} iterations of the demo's 50 (10 before the time "
              f"limit's cut)", flush=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gd = graddesign.design_gradient_2d(yl0, yr0, gcontour, iters=iters,
                                           device=dev, **gkw)
        torch.cuda.synchronize()
        gd_s = time.perf_counter() - t0
        hold = np.asarray(gd["holdout"])
        check(len(gd["history"]) == iters
              and np.isfinite(gd["history"]).all()
              and len(hold) == iters + 1 and np.isfinite(hold).all(),
              "gradient design: finite history and holdout")
        check(gd["best_iter"] == int(np.argmax(hold)) - 1
              and (gd["best_iter"] >= 0
                   or np.array_equal(gd["y"], gd["y0"])),
              "gradient design: best_iter is the held-out argmax")
        g = GRIPPER_2D
        check(gd["y"].min() >= g.ctrl_y_min - 1e-6
              and gd["y"].max() <= g.ctrl_y_max + 1e-6,
              "gradient design: the design stays in the control range")
        print(f"  smoothed: {gd_s:.2f}s for {iters} iterations and the "
              f"held-out pass ({gd_s / iters:.3f} s an iteration); history "
              f"{np.round(gd['history'], 4).tolist()}; held-out "
              f"{np.round(hold, 4).tolist()}; best iterate "
              f"{gd['best_iter']}", flush=True)
        # iteration 0 against the same call on the CPU (the held-out draws
        # come from another stream, so one draw does there)
        t0 = time.perf_counter()
        cpu = graddesign.design_gradient_2d(
            yl0, yr0, gcontour, iters=1, device="cpu",
            **{**gkw, "holdout_draws": 1})
        cpu_s = time.perf_counter() - t0
        it0_err = float(np.abs(gd["objectives"][0]
                               - cpu["objectives"][0]).max())
        check(it0_err < 2e-3, f"iteration 0 card vs CPU: {it0_err:.3g}")
        print(f"  iteration 0's 8 candidate objectives, card vs CPU: max "
              f"|diff| {it0_err:.3g} (bar 2e-3; the CPU call "
              f"{cpu_s:.1f}s)", flush=True)
        # the backprop estimator
        t0 = time.perf_counter()
        bp_iters = GRAD_BACKPROP_ITERS
        bp = graddesign.design_gradient_2d(yl0, yr0, gcontour,
                                           iters=bp_iters, method="backprop",
                                           device=dev, **gkw)
        torch.cuda.synchronize()
        bp_s = time.perf_counter() - t0
        check(len(bp["grad_norms"]) == bp_iters
              and np.isfinite(bp["grad_norms"]).all()
              and min(bp["grad_norms"]) > 0
              and np.isfinite(bp["history"]).all(),
              f"backprop: finite, non-zero gradients {bp['grad_norms']}")
        print(f"  backprop: {bp_iters} iteration(s) (2 before the time "
              f"limit's cut) and the held-out pass {bp_s:.2f}s, gradient "
              f"norms {np.round(bp['grad_norms'], 4).tolist()}", flush=True)
        # start and designed gripper on 96 orientations, as the demo
        # evaluates them: the pure engine and K1, under both solvers
        th = np.linspace(0, 2 * np.pi, 96, endpoint=False)
        p96 = np.stack([np.zeros_like(th), np.zeros_like(th), th],
                       -1).astype(np.float32)
        designs = {"start": gd["y0"], "designed": gd["y"]}
        scenes = {k: engine2d.make_scene(v[0].astype(np.float64),
                                         v[1].astype(np.float64), gcontour)
                  for k, v in designs.items()}
        pose_t = torch.as_tensor(p96, device=dev)
        pose_k = torch.as_tensor(datagen.pad_poses(p96), device=dev)
        evals, k96 = {}, {}
        for solver in ("jacobi", "newton"):
            # each solver with its own calibration (default_calib)
            engine2d.SOLVER = solver
            arrs = rollout2d.scene_arrays(datagen.stack_scenes(
                list(scenes.values())), device=dev)
            t0 = time.perf_counter()
            pure = [engine2d.profile(to_device(sc, dev), pose_t)[0]
                    for sc in scenes.values()]
            torch.cuda.synchronize()
            pure_s = time.perf_counter() - t0
            kout = rollout2d.profile_batch(*arrs, pose_k)
            kern = kout[0][:, :96]
            k96[solver] = (arrs, kout)
            for i, k in enumerate(designs):
                # the demo's statistics of rotate_clockwise: the mean of
                # -dtheta and the share of orientations above 0.03 rad
                a = -pure[i].cpu().numpy()
                b = -kern[i].cpu().numpy()
                check(np.isfinite(a).all() and np.isfinite(b).all(),
                      f"96-orientation evaluation {solver} {k}")
                evals[f"{solver}_{k}"] = {
                    "pure_mean": float(np.mean(a)),
                    "pure_success": float(np.mean(a > 0.03)),
                    "k1_mean": float(np.mean(b)),
                    "k1_success": float(np.mean(b > 0.03))}
            evals[f"{solver}_pure_s"] = pure_s
        engine2d.SOLVER = "jacobi"
        launches = dict(rollout2d.KERNEL_LAUNCHES)
        check(launches["rollout2d_jacobi"] == 2 and launches["rollout2d"] == 1,
              f"phase 10 main path: K1 Jacobi 2, Newton 1 launches: "
              f"{launches}")
        for k, v in evals.items():
            print(f"  96 orientations, {k}: {v}", flush=True)

        # ---- outside the counted run: the plain versions of the main path's
        # K1 calls, (b)'s kernel alone and its snapshot ----------------------
        for solver, (arrs, kout) in k96.items():
            r = profile_batch_ref(*arrs, pose_k, solver=solver,
                                  sum_group=rollout2d.THREADS_PER_ROLLOUT)
            bitwise(f"K1 {solver} 96 orientations 2x128x200 (the main path's "
                    f"call)", kout, (r[0], torch.stack(r[1:3], -1), r[3],
                                     torch.stack(r[4:6], -1)), range(4))
        arrs16 = rollout2d.scene_arrays(inp["scenes16"], device=dev)
        eposes = inp["eposes"]
        ekw = dict(steps=SIM.eval_steps_2d, regrasp_every=SIM.eval_regrasp_2d,
                   snapshot_step=SIM.eval_regrasp_2d)
        ev_ms, ev = timed_cuda(lambda: rollout2d.rollout(*arrs16, eposes,
                                                          **ekw), reps=1)
        sq = rollout2d.rollout(*arrs16, eposes, steps=SIM.eval_regrasp_2d)
        bitwise("K1 Jacobi verify 16x384x8000: 200-step snapshot vs the "
                "kernel's own 200-step squeeze", ev, sq, (0, 1, 2))
        check(all(np.array_equal(
            metrics[i]["delta_theta"],
            ev[0][i, :360].cpu().numpy() * 180.0 / np.pi) for i in range(16)),
            "sim_eval_batch_2d's profiles are this kernel's snapshot")
        # the verify shape with its depth cut, against the plain version:
        # the squeeze, its snapshot and regrasp at 200 and 200 steps of the
        # second squeeze
        cut = K1_JACOBI_VERIFY_CUT
        ckw = {**ekw, "steps": cut}
        c_out = rollout2d.rollout(*arrs16, eposes, **ckw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_ref = profile_batch_ref(*arrs16, eposes, **ckw,
                                  sum_group=rollout2d.THREADS_PER_ROLLOUT)
        torch.cuda.synchronize()
        cut_plain_s = time.perf_counter() - t0
        bitwise(f"K1 Jacobi verify 16x384x{cut} (depth cut from 8,000 to "
                f"{cut}, 1,000 before the time limit's cut; regrasp and "
                f"snapshot at {ekw['snapshot_step']})", c_out, c_ref,
                range(9))
        c_full = float(c_out[6][:, ::128].float().mean())
        check(c_full > 0, f"K1 Jacobi verify cut to {cut}: no full steps")
        print(f"  plain Jacobi K1 at 16x384x{cut}: {cut_plain_s:.1f}s; full "
              f"steps per block {c_full:.0f} of {cut}", flush=True)
        ev_np = {k: v.cpu().numpy() for k, v in zip(NAMES, ev)}
        ev_bound, ev_bound_by = bound_ms(
            k1_jacobi_flops(contour.shape[0], s_, ekw["steps"],
                            ev_np["cfull"], ev_np["ccheap"]),
            k1_bytes(16, contour.shape[0], s_, 384))
        print(f"  K1 Jacobi verify 16x384x8000: {chosen(rollout2d)}; "
              f"sim_eval_batch_2d {ev_call_s:.2f}s on the host clock, "
              f"kernel {ev_ms:.1f} ms ({pr9('262.6 ms')}), bound "
              f"{ev_bound:.2f} ms ({ev_bound_by}), "
              f"{100.0 * ev_bound / ev_ms:.1f}% of it; full steps per block "
              f"{ev_np['cfull'][:, ::128].mean():.0f} of 8,000", flush=True)
        # the pure engine's cost on the card, both solvers
        base = to_device(scenes["start"], dev)
        y0 = torch.as_tensor(gd["y0"], device=dev)
        cost = {}
        for solver in ("jacobi", "newton"):
            engine2d.SOLVER = solver
            cost[solver] = engine_step_cost(dev, base, y0)
            print(f"  pure engine ({solver}) at 8 x 36 rollouts: "
                  f"{cost[solver]}", flush=True)
        out = {"datagen": {"kernel_ms": dg_ms, "plain_ms": dg_plain_ms,
                           "bound_ms": dg_bound, "bound_by": dg_bound_by,
                           "parity": stats, "plan": dg_plan,
                           "full_steps_per_block": float(
                               res_np["cfull"][:, ::128].mean())},
               "verify": {"kernel_ms": ev_ms, "call_s": ev_call_s,
                          "cut_steps": cut, "cut_plain_s": cut_plain_s,
                          "bound_ms": ev_bound, "bound_by": ev_bound_by,
                          "full_steps_per_block": float(
                              ev_np["cfull"][:, ::128].mean())},
               "design": {"seconds": gd_s, "iters": iters,
                          "history": gd["history"], "holdout": gd["holdout"],
                          "best_iter": gd["best_iter"],
                          "iteration0_cpu_err": it0_err, "cpu_s": cpu_s,
                          "backprop_s": bp_s,
                          "backprop_grad_norms": bp["grad_norms"],
                          "eval96": evals},
               "engine_cost": cost, "launches": launches,
               "seconds": time.perf_counter() - t_phase}
    finally:
        engine2d.SOLVER = old_solver
    return out


def k2_jacobi_flops(p: int, steps: int, cfull, ccheap, citer) -> float:
    """Operations the 3D Jacobi rollouts of this run need, counted by hand
    from ``_jacobi_solve`` of dgdm_tpu_torch/sim/rollout3d_ref.py, per lane:
    a full step (every normal Jacobi step) first spans the points' wy (5 a
    point), then pass A's plane arm and finger narrow phase (~215 a point:
    two bivariate Horner evaluations, normals, contact mass, velocity) and
    the elastic impulse with its ten sums (~45), the clamp's min (~40) and
    the grip sum (~10), ~150 of lane-level updates; each Jacobi sweep
    (``citer`` counts them) a finger pass (~90 a point) and a plane pass
    (~60), their sums and the velocity updates (~60); a travel step the
    servo update (15); every step the gates (25). Like the plain version,
    the kernel computes a point's masses, targets and caps once a step
    (an earlier design recomputed them in every pass, which would not have
    counted either): the bound is the least work of the function."""
    cf, cc, ci = (np.asarray(x, np.float64) for x in (cfull, ccheap, citer))
    travel = steps - cf - cc
    return float(np.sum(cf * (p * (5 + 215 + 45 + 40 + 10) + 150)
                        + ci * (p * (90 + 60) + 60)
                        + travel * 15 + steps * 25))


def k2_plain_bitwise(what, kernel, plain, names) -> None:
    """All 12 K2 output planes bitwise equal to the plain version."""
    import torch

    bad = [n for n, a, b in zip(names, kernel, plain) if not torch.equal(a, b)]
    check(not bad, f"{what}: planes {bad} differ from the plain version")
    print(f"  {what}: all 12 planes bitwise equal to the plain version",
          flush=True)


def plain_cut_k2(what, kernel, plain, flops, steps: int) -> dict:
    """K2 at the datagen shape (8 x 9,088 poses) with its depth cut from 800
    to ``steps``: ``kernel(steps)`` timed with CUDA events, ``plain(steps)``
    on the same inputs on the host clock, all 12 planes bitwise equal, the
    bound of this work from ``flops(outputs, steps)``. The kernel's step
    counters must show full-solve steps."""
    import torch

    from dgdm_tpu_torch.sim.rollout3d_ref import OUT_NAMES

    ms, out = timed_cuda(lambda: kernel(steps), reps=1, warm=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain(steps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    k2_plain_bitwise(f"{what} 8x9088x{steps} (depth cut from 800 to {steps}, "
                     f"all 800 before the time limit's cut)", out, ref,
                     OUT_NAMES)
    full = float(out[9][:, ::128].float().mean())
    check(full > 0, f"{what} cut to {steps} steps: no full-solve steps")
    bound, by = bound_ms(flops(out, steps), k2_bytes(8, 256, 9088))
    print(f"  {what} 8x9088x{steps}: kernel {ms:.1f} ms, plain "
          f"{plain_s:.1f}s, bound {bound:.2f} ms ({by}); full steps per block "
          f"{full:.1f} of {steps}", flush=True)
    return {"steps": steps, "kernel_ms": ms, "plain_ms": 1e3 * plain_s,
            "bound_ms": bound, "bound_by": by, "full_steps_per_block": full}


def jacobi_parity(out, ref, what: str, valid_min: float = 0.95) -> dict:
    """The Jacobi bars of tests/test_torch_rollout3d_jacobi.py (set from
    scripts/probe_rollout3d_chaos.py --solver jacobi): the reference moved;
    >= 75% of lanes within 1e-3 for dtheta, >= 95% for dpx and dpy, median
    |ddtheta| <= 1e-4, validity equal on ``valid_min`` of the lanes,
    counters equal per block."""
    check(float(np.abs(ref["dth"]).max()) > 1e-2, f"{what}: reference did "
          "not move")
    stats = {}
    for k, need in (("dth", 0.75), ("dpx", 0.95), ("dpy", 0.95)):
        err = np.abs(np.asarray(out[k]) - np.asarray(ref[k]))
        stats[k] = {"frac_1e-3": float(np.mean(err < 1e-3)),
                    "median": float(np.median(err)),
                    "max_abs_err": float(err.max())}
        check(np.isfinite(out[k]).all() and stats[k]["frac_1e-3"] >= need,
              f"{what}: {k} {stats[k]}")
    check(stats["dth"]["median"] <= 1e-4, f"{what}: median {stats['dth']}")
    valid = float(np.mean(out["valid"] == ref["valid"]))
    check(valid >= valid_min, f"{what}: validity equal on {valid:.4f}")
    for k in ("cfull", "ccheap", "citer"):
        check(np.array_equal(out[k][:, ::128], ref[k][:, ::128]),
              f"{what}: {k} counters differ")
    print(f"  {what}: " + ", ".join(
        f"{k} {v['frac_1e-3']:.4f} within 1e-3 (median {v['median']:.3g}, "
        f"max {v['max_abs_err']:.3g})" for k, v in stats.items())
        + f", validity equal {valid:.4f}", flush=True)
    return stats


def engine_vs_kernel(e, k, what: str, solver: str) -> dict:
    """The pure engine against K2 on the same pairs and poses, after the
    guard (max |dtheta| > 1e-2). Newton: the bars of
    tests/test_pallas3d.py:54-61 (median |ddpos| < 1e-3, max |ddpos| <
    2e-2, corr > 0.98, validity equal), but |ddtheta| < 2e-2 on >= 99.5% of
    the lanes, not all: over 800 steps on the datagen grid the squeeze is in
    its grip, where 3 of 3,600 lanes go past 2e-2 (max 2.6e-2; ROADMAP
    Queue 3). Jacobi: the two are different functions (the kernel merges a
    point's finger contacts and sweeps the finger set, then the plane set),
    and the JAX package's own engine and Pallas kernel come only so close
    (82.8% of lanes within 2e-2, corr 0.869, median |ddpos| 2.2e-4, max
    6.6e-3, validity equal on 81.3%: ``scripts/probe_rollout3d_chaos.py
    --solver jacobi --engine_vs_kernel``): >= 75% within 2e-2, corr > 0.85,
    median |ddpos| < 1e-3, max < 2e-2, validity equal on >= 80%."""
    (ed, ep, ev), (kd, kp, kv) = e, k
    check(np.isfinite(ed).all() and np.isfinite(ep).all(),
          f"{what}: finite")
    check(float(np.abs(kd).max()) > 1e-2, f"{what}: K2 did not move")
    err, perr = np.abs(ed - kd), np.abs(ep - kp)
    st = {"frac_dth_2e-2": float(np.mean(err < 2e-2)),
          "max_dth_err": float(err.max()),
          "median_dpos_err": float(np.median(perr)),
          "max_dpos_err": float(perr.max()),
          "corr": float(np.corrcoef(ed.ravel(), kd.ravel())[0, 1]),
          "valid_equal": float(np.mean(ev == kv))}
    print(f"  {what}: {st}", flush=True)
    frac, corr, valid = ((0.995, 0.98, 1.0) if solver == "newton"
                         else (0.75, 0.85, 0.8))
    check(st["frac_dth_2e-2"] >= frac and st["median_dpos_err"] < 1e-3
          and st["max_dpos_err"] < 2e-2 and st["corr"] > corr
          and st["valid_equal"] >= valid, f"{what}: {st}")
    return st


def step_profile(step, n: int = 10) -> dict:
    """CUDA kernels a step and the card's busy share (summed device time
    over the window's wall) of ``n`` calls of ``step`` under
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, launches = 0.0, 0
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        busy_us += dev_us
        launches += e.count
    return {"kernels_per_step": launches / n,
            "busy_share": busy_us / (1e6 * wall) if busy_us else None,
            "profiled_ms_per_step": 1e3 * wall / n}


def pure_step_cost(dev, scenes, grid) -> dict:
    """The pure 3D engine's cost on the card at 8 pairs x 450 poses under
    each solver: ms a step (CUDA events over 5 steps after 2), and from a
    torch.profiler window of 10 steps the CUDA kernels a step and the card's
    busy share (their summed device time over the window's wall)."""
    import torch

    from dgdm_tpu_torch.sim import engine3d
    from dgdm_tpu_torch.sim.types import to_device

    sc = engine3d.expand_scene3(to_device(engine3d.with_hgrid(scenes), dev),
                                1)
    pose = torch.as_tensor(grid[:450], device=dev)
    ctrl = torch.tensor([0.5, -0.5], device=dev)
    cost = {}
    old = engine3d.SOLVER3
    try:
        for solver in engine3d.SOLVERS3:
            engine3d.SOLVER3 = solver
            state = [engine3d.init_state(sc, pose)]

            def step():
                state[0] = engine3d.step(sc, state[0], ctrl)
                return state[0]

            for _ in range(2):
                step()
            ms, _ = timed_cuda(step, reps=5, warm=False)
            cost[solver] = {"ms_per_step": ms, **step_profile(step)}
            print(f"  pure engine ({solver}) at 8 x 450 rollouts: "
                  f"{cost[solver]}", flush=True)
    finally:
        engine3d.SOLVER3 = old
    return cost


def k2_inputs(dev) -> dict:
    """Phase 11's inputs of K2 (scripts/probe_kernel_ab.py reads them too):
    the mug with grippers 0-7 as scenes over the 9,088-pose grid (the
    datagen shape), and grippers 100-115 normalised (``pts``) and as scenes,
    with ``nrot`` = 45 orientations (``thetas``) padded to 128 poses (the
    verification shape). Poses lie on ``dev``; the scenes stay on the host, so that the
    caller builds their arrays under the solver it sets."""
    import torch

    from dgdm_tpu_torch.geom import mesh3d
    from dgdm_tpu_torch.geom.fingers import (denormalize_y, normalize_y,
                                             sample_gripper_3d)
    from dgdm_tpu_torch.sim import datagen, engine2d, engine3d

    verts, faces = mesh3d.load_obj(MUG)
    props = engine3d.object_properties_3d(verts, faces)
    scenes8 = datagen.stack_scenes([
        engine3d.make_scene(*sample_gripper_3d(i), verts, faces,
                            obj_props=props) for i in range(8)])
    grid = engine2d.pose_grid()
    ys = np.stack([np.concatenate(sample_gripper_3d(100 + i))
                   for i in range(16)])
    pts = normalize_y(ys, fingers_3d=True)
    scenes16 = datagen.stack_scenes([
        engine3d.make_scene(yi[:21], yi[21:], verts, faces, obj_props=props)
        for yi in denormalize_y(pts, fingers_3d=True)])
    nrot = 45
    thetas = (np.linspace(-1.0, 1.0, nrot) * np.pi + np.pi).astype(
        np.float32)
    th_p = datagen.pad_poses(thetas[:, None])[:, 0]
    eposes = np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1)
    return {"verts": verts, "faces": faces, "props": props,
            "scenes8": scenes8, "grid": grid,
            "poses": torch.as_tensor(datagen.pad_poses(grid), device=dev),
            "pts": pts, "scenes16": scenes16, "nrot": nrot, "thetas": thetas,
            "eposes": torch.as_tensor(eposes, device=dev)}


def phase_3d_solvers(dev) -> dict:
    """Phase 11: K2's Jacobi instantiation at the datagen and verification
    shapes (engine3d.SOLVER3 = "jacobi", restored after), its adaptive-Newton
    instantiation at the datagen shape, and the pure 3D engine on the card.
    The launch counts are reset just before each main-path call and read
    just after. Returns the numbers for the summary."""
    import torch

    from dgdm_tpu_torch.core.config import SIM
    from dgdm_tpu_torch.eval.simeval3d import (eval_rollout_batch_3d,
                                               sim_eval_batch_3d)
    from dgdm_tpu_torch.geom.fingers import sample_gripper_3d
    from dgdm_tpu_torch.sim import datagen, datagen3d, engine3d, rollout3d
    from dgdm_tpu_torch.sim.rollout3d_ref import OUT_NAMES, profile_batch_ref
    from dgdm_tpu_torch.sim.types import to_device

    def reset():
        for k in rollout3d.KERNEL_LAUNCHES:
            rollout3d.KERNEL_LAUNCHES[k] = 0

    g32 = rollout3d.THREADS_PER_ROLLOUT
    out: dict = {}
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inp = k2_inputs(dev)
    verts, faces, props = inp["verts"], inp["faces"], inp["props"]
    scenes8, grid, poses = inp["scenes8"], inp["grid"], inp["poses"]
    old = engine3d.SOLVER3
    try:
        engine3d.SOLVER3 = "jacobi"
        # ---- (a) K2 Jacobi at the datagen shape, through profile_pairs_3d
        reset()
        t0 = time.perf_counter()
        dth, dpos, valid = datagen3d.profile_pairs_3d(scenes8, grid,
                                                      device=dev)
        a_call_s = time.perf_counter() - t0
        a_launches = dict(rollout3d.KERNEL_LAUNCHES)
        check(a_launches["rollout3d_jacobi"] == 1
              and a_launches["rollout3d"] == 0,
              f"(a) launched the Jacobi instantiation once: {a_launches}")
        arrs8 = rollout3d.scene_arrays_3d(scenes8, device=dev)
        check(float(arrs8[2][0, 0, 14]) == engine3d.default_calib3()
              .k_contact and float(arrs8[2][0, 0, 12]) == 1.0,
              "the Jacobi calibration in the scalar slots")
        # three calls, timed one by one (profile_pairs_3d warmed it)
        dg_runs = []
        for _ in range(3):
            t, raw = timed_cuda(lambda: rollout3d.rollout(*arrs8, poses),
                                reps=1, warm=False)
            dg_runs.append(t)
        dg_ms = float(np.mean(dg_runs))
        dg_plan = dict(rollout3d.LAST_PLAN)
        plan = chosen(rollout3d)
        rv = k2_view(raw, poses)
        check(np.array_equal(rv["dth"][:, :9000], dth)
              and np.array_equal(rv["valid"][:, :9000], valid),
              "(a) profile_pairs_3d returns this kernel's outputs")
        check((rv["ccheap"] == 0).all(), "Jacobi: no cheap steps")
        a_bound, a_bound_by = bound_ms(
            k2_jacobi_flops(256, SIM.steps_3d, raw[9].cpu(), raw[10].cpu(),
                            raw[11].cpu()), k2_bytes(8, 256, 9088))
        spread = 100.0 * (max(dg_runs) - min(dg_runs)) / dg_ms
        print(f"  K2 Jacobi datagen 8x9088x800: {plan}; profile_pairs_3d "
              f"{a_call_s:.2f}s on the host clock, kernel {dg_ms:.1f} ms "
              f"(calls {', '.join(f'{t:.1f}' for t in dg_runs)}: spread "
              f"{spread:.2f}%; not measured here: the earlier design, commit "
              f"287298e, 4,027 ms in PERF.md section 6), bound "
              f"{a_bound:.2f} ms ({a_bound_by}), "
              f"{100.0 * a_bound / dg_ms:.1f}% of it; full steps per block "
              f"{rv['cfull'][:, ::128].mean():.0f} of 800, valid "
              f"{rv['valid'].mean():.4f}", flush=True)
        # the plain version with its depth cut: the grip begins after ~300
        # steps
        a_cut = plain_cut_k2(
            "K2 Jacobi datagen", lambda steps: rollout3d.rollout(
                *arrs8, poses, steps=steps),
            lambda steps: profile_batch_ref(*arrs8, poses, steps=steps,
                                            sum_group=g32),
            lambda o, steps: k2_jacobi_flops(256, steps, o[9].cpu(),
                                             o[10].cpu(), o[11].cpu()),
            K2_JACOBI_DATAGEN_CUT)
        gold = np.load(os.path.join(ROOT, "tests", "fixtures",
                                    "rollout3d_jacobi_golden.npz"))
        check(str(gold["solver"]) == "jacobi", "Jacobi golden fixture")
        garrs = [torch.as_tensor(gold[k], device=dev)
                 for k in ("coefs", "points", "scalars")]
        gposes = torch.as_tensor(gold["poses"], device=dev)
        a_gold = {}
        for sched in ("datagen", "eval"):
            steps, rg, snap = (int(v) for v in gold[f"{sched}_schedule"])
            g_out = rollout3d.rollout(*garrs, gposes, steps=steps,
                                      regrasp_every=rg, snapshot_step=snap)
            g_ref = [torch.as_tensor(gold[f"{sched}_{k}"], device=dev)
                     for k in OUT_NAMES]
            a_gold[sched] = jacobi_parity(
                k2_view(g_out, gposes), k2_view(g_ref, gposes),
                f"K2 Jacobi golden {sched} ({steps} steps), kernel vs TPU "
                f"kernel", valid_min=JACOBI_VALID_MIN[sched])
        out["datagen"] = {"kernel_ms": dg_ms, "runs_ms": dg_runs,
                          "plan": dg_plan, "call_s": a_call_s,
                          "cut": a_cut,
                          "bound_ms": a_bound, "bound_by": a_bound_by,
                          "full_steps_per_block": float(
                              rv["cfull"][:, ::128].mean()),
                          "golden": a_gold, "launches": a_launches}

        # ---- (b) the verification shape through sim_eval_batch_3d ------
        pts, nrot, thetas = inp["pts"], inp["nrot"], inp["thetas"]
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = sim_eval_batch_3d(pts, [(verts, faces)], num_rot=nrot,
                                    device=dev)
        torch.cuda.synchronize()
        b_call_s = time.perf_counter() - t0
        b_launches = dict(rollout3d.KERNEL_LAUNCHES)
        check(b_launches["rollout3d_jacobi"] == 1
              and b_launches["rollout3d"] == 0,
              f"(b) verification launched the Jacobi branch once: "
              f"{b_launches}")
        check(len(metrics) == 16 and all(
            np.isfinite(m["delta_theta"]).all() for m in metrics),
            "sim_eval_batch_3d: 16 finite metric dicts")
        scenes16 = inp["scenes16"]
        arrs16 = rollout3d.scene_arrays_3d(scenes16, device=dev)
        eposes = inp["eposes"]
        ekw = dict(regrasp_every=SIM.eval_regrasp_3d,
                   snapshot_step=SIM.eval_regrasp_3d)
        ev_ms, ev = timed_cuda(lambda: rollout3d.rollout(
            *arrs16, eposes, steps=SIM.eval_steps_3d, **ekw), reps=1,
            warm=False)
        ev_plan = dict(rollout3d.LAST_PLAN)
        # the tail: 15 grippers fill one wave of the resident clusters, the
        # 16th runs alone in a second
        a15 = [a[:15].contiguous() for a in arrs16]
        t15_ms, _ = timed_cuda(lambda: rollout3d.rollout(
            *a15, eposes, steps=SIM.eval_steps_3d, **ekw), reps=1,
            warm=False)
        sq = rollout3d.rollout(*arrs16, eposes, steps=SIM.eval_regrasp_3d)
        for a in range(5, 9):
            check(torch.equal(ev[a], sq[a]),
                  f"Jacobi verify: snapshot {OUT_NAMES[a]} differs from the "
                  f"800-step squeeze's")
        evv = k2_view(ev, eposes)
        check(all(np.array_equal(metrics[i]["delta_theta"],
                                 evv["dth"][i, :nrot] * 180 / np.pi)
                  for i in range(16)),
              "sim_eval_batch_3d's profiles are this kernel's snapshot")
        # the plain version takes ~75 ms a step at this shape (its time is
        # the host's, 2,048 rollouts); the cut covers the squeeze, the
        # snapshot and regrasp at 800 and 50 steps of the second squeeze
        cut_b = K2_JACOBI_VERIFY_CUT
        ckw = dict(ekw, steps=cut_b)
        cb_ms, cb_out = timed_cuda(lambda: rollout3d.rollout(
            *arrs16, eposes, **ckw), reps=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cb_ref = profile_batch_ref(*arrs16, eposes, **ckw, sum_group=g32)
        torch.cuda.synchronize()
        b_plain_s = time.perf_counter() - t0
        k2_plain_bitwise(f"K2 Jacobi verify 16x128x{cut_b} (depth cut from "
                         f"32,000 to {cut_b}, 1,000 before the time limit's "
                         f"cut; regrasp and snapshot at 800)", cb_out,
                         cb_ref, OUT_NAMES)
        b_bound, b_bound_by = bound_ms(
            k2_jacobi_flops(256, SIM.eval_steps_3d, ev[9].cpu(),
                            ev[10].cpu(), ev[11].cpu()),
            k2_bytes(16, 256, 128))
        print(f"  K2 Jacobi verify 16x128x32000: {chosen(rollout3d)}; "
              f"sim_eval_batch_3d {b_call_s:.2f}s on the host clock, kernel "
              f"{ev_ms:.0f} ms (not measured here: the earlier design, commit "
              f"287298e, 8,483 ms in PERF.md section 6), bound "
              f"{b_bound:.2f} ms ({b_bound_by}), "
              f"{100.0 * b_bound / ev_ms:.1f}% of it; "
              f"snapshot bitwise equal to the 800-step squeeze; at {cut_b} "
              f"steps kernel {cb_ms:.0f} ms, plain {b_plain_s:.1f}s",
              flush=True)
        print(f"  K2 Jacobi verify tail: 15 grippers {t15_ms:.0f} ms, 16 "
              f"{ev_ms:.0f} ms ({ev_ms / t15_ms:.2f}x): "
              f"{ev_plan['max_active_clusters']} clusters of "
              f"{ev_plan['cluster']} resident, so the 16th gripper's cluster "
              f"runs alone in a second wave", flush=True)
        out["verify"] = {"kernel_ms": ev_ms, "plan": ev_plan,
                         "kernel_ms_15": t15_ms, "call_s": b_call_s,
                         "bound_ms": b_bound, "bound_by": b_bound_by,
                         "cut_steps": cut_b, "cut_kernel_ms": cb_ms,
                         "cut_plain_s": b_plain_s, "launches": b_launches}

        # ---- (c) the adaptive Newton loop at the datagen shape ----------
        engine3d.SOLVER3 = "newton"
        tol = dict(newton_iters=6, newton_tol=1e-4)
        arrs8n = rollout3d.scene_arrays_3d(scenes8, device=dev)
        reset()
        t0 = time.perf_counter()
        res = rollout3d.profile_batch(*arrs8n, poses, return_step_mix=True,
                                      **tol)
        torch.cuda.synchronize()
        c_call_s = time.perf_counter() - t0
        c_launches = dict(rollout3d.KERNEL_LAUNCHES)
        check(c_launches["rollout3d_newton_tol"] == 1
              and c_launches["rollout3d"] == 0,
              f"(c) launched the adaptive instantiation once: {c_launches}")
        tol_ms, traw = timed_cuda(lambda: rollout3d.rollout(
            *arrs8n, poses, **tol), reps=1)
        tol_plan = dict(rollout3d.LAST_PLAN)
        check(all(torch.equal(a, b) for a, b in zip(res[-1], traw[9:])),
              "(c) profile_batch returns this kernel's counters")
        fix_ms, fraw = timed_cuda(lambda: rollout3d.rollout(*arrs8n, poses),
                                  reps=1)
        c_cut = plain_cut_k2(
            "K2 newton_tol datagen (newton_iters 6, newton_tol 1e-4)",
            lambda steps: rollout3d.rollout(*arrs8n, poses, steps=steps,
                                            **tol),
            lambda steps: profile_batch_ref(*arrs8n, poses, steps=steps,
                                            sum_group=g32, **tol),
            lambda o, steps: k2_flops(256, steps, o[9].cpu(), o[10].cpu(),
                                      o[11].cpu()), K2_NEWTON_TOL_CUT)
        cf = traw[9][:, ::128].cpu().numpy()
        ci = traw[11][:, ::128].cpu().numpy()
        per = ci[cf > 0] / cf[cf > 0]
        c_bound, c_bound_by = bound_ms(
            k2_flops(256, SIM.steps_3d, traw[9].cpu(), traw[10].cpu(),
                     traw[11].cpu()), k2_bytes(8, 256, 9088))
        print(f"  K2 newton_tol datagen 8x9088x800: {chosen(rollout3d)}; "
              f"kernel {tol_ms:.1f} ms ("
              f"{pr9('2,095.9 ms and 4.59 iterations a full step')}; the "
              f"fixed count of {rollout3d.NEWTON_KERNEL_ITERS3}: "
              f"{fix_ms:.1f} ms), bound "
              f"{c_bound:.2f} ms ({c_bound_by}), "
              f"{100.0 * c_bound / tol_ms:.1f}% of it; Newton iterations a "
              f"full step per block: "
              f"mean {per.mean():.2f}, max {per.max():.2f} (fixed count: "
              f"{float(fraw[11][:, ::128].sum() / fraw[9][:, ::128].sum()):.2f}"
              f")"
              f"; full steps per block {cf.mean():.1f} (fixed "
              f"{float(fraw[9][:, ::128].float().mean()):.1f})", flush=True)
        check(len(np.unique(ci)) > 1, "iteration counts differ between "
              "blocks")
        tgold = np.load(os.path.join(ROOT, "tests", "fixtures",
                                     "rollout3d_newton_tol_golden.npz"))
        tgarrs = [torch.as_tensor(tgold[k], device=dev)
                  for k in ("coefs", "points", "scalars")]
        tgp = torch.as_tensor(tgold["poses"], device=dev)
        c_gold = {}
        for sched in ("datagen", "eval"):
            steps, rg, snap = (int(v) for v in tgold[f"{sched}_schedule"])
            g_out = rollout3d.rollout(*tgarrs, tgp, steps=steps,
                                      regrasp_every=rg, snapshot_step=snap,
                                      **tol)
            g_ref = [torch.as_tensor(tgold[f"{sched}_{k}"], device=dev)
                     for k in OUT_NAMES]
            c_gold[sched] = parity(
                k2_view(g_out, tgp), k2_view(g_ref, tgp),
                f"K2 newton_tol golden {sched} ({steps} steps), kernel vs "
                f"TPU kernel")
        out["newton_tol"] = {
            "kernel_ms": tol_ms, "fixed_kernel_ms": fix_ms, "plan": tol_plan,
            "call_s": c_call_s, "cut": c_cut,
            "bound_ms": c_bound, "bound_by": c_bound_by,
            "iters_per_full_step_mean": float(per.mean()),
            "iters_per_full_step_max": float(per.max()),
            "golden": c_gold, "launches": c_launches}

        # ---- (d) the pure engine on the card -----------------------------
        chunk = grid[:450]
        pure = {}
        for solver in ("newton", "jacobi"):
            engine3d.SOLVER3 = solver
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e = datagen3d.profile_pairs_3d(scenes8, chunk, device=dev,
                                           use_pallas=False)
            torch.cuda.synchronize()
            e_s = time.perf_counter() - t0
            k = datagen3d.profile_pairs_3d(scenes8, chunk, device=dev)
            pure[solver] = {"seconds": e_s, "ms_per_step": 1e3 * e_s / 800,
                            **engine_vs_kernel(
                                e, k, f"pure engine vs K2 ({solver}), "
                                f"8x450x800 ({e_s:.1f}s)", solver)}
        engine3d.SOLVER3 = "newton"
        th45 = torch.as_tensor(thetas, device=dev)
        sc16 = to_device(scenes16, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cut_d = PURE3D_EVAL_CUT
        ed, ep, ef, efp = eval_rollout_batch_3d(
            sc16, th45, first_squeeze=800, total_steps=cut_d,
            regrasp_every=800)
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - t0
        check(all(torch.isfinite(a).all() for a in (ed, ep, ef, efp)),
              "eval_rollout_batch_3d: finite")
        kb = rollout3d.profile_batch(*rollout3d.scene_arrays_3d(
            scenes16, device=dev), eposes, steps=cut_d, **ekw)
        eval_st = engine_vs_kernel(
            (ed.cpu().numpy(), ep.cpu().numpy(), np.ones_like(
                ed.cpu().numpy(), bool)),
            (kb[0][:, :nrot].cpu().numpy(), kb[1][:, :nrot].cpu().numpy(),
             np.ones((16, nrot), bool)),
            f"eval_rollout_batch_3d 16x45x{cut_d} (depth cut from 32,000 to "
            f"{cut_d}, 1,600 before the time limit's cut; snapshot and "
            f"regrasp at 800) vs K2's snapshot ({ev_s:.1f}s)", "newton")
        tr_steps = PURE3D_TRACE_STEPS
        tr = engine3d.rollout_trace3d(engine3d.with_hgrid(to_device(
            type(scenes16)(**{f: (None if v is None else v[0])
                              for f, v in vars(scenes16).items()}), dev)),
            torch.tensor([0.0, 0.0, float(thetas[0])], device=dev),
            steps=tr_steps, every=20)
        check(tuple(tr.shape) == (tr_steps // 20, 9)
              and torch.isfinite(tr).all(),
              f"rollout_trace3d: finite ({tr_steps // 20}, 9), got "
              f"{tuple(tr.shape)}")
        cost = pure_step_cost(dev, scenes8, grid)
        # one step card vs CPU for each solver, from a mid-squeeze state
        sc2 = engine3d.expand_scene3(engine3d.with_hgrid(
            datagen.stack_scenes([engine3d.make_scene(
                *sample_gripper_3d(i), verts, faces, obj_props=props)
                for i in (2, 3)])), 1)
        p16 = torch.as_tensor(np.stack([np.zeros(16), np.zeros(16),
                                        np.linspace(0, 6.0, 16)], -1),
                              dtype=torch.float32)
        scd = to_device(sc2, dev)
        st = engine3d.init_state(scd, p16.to(dev))
        ctrl = torch.tensor([0.5, -0.5], device=dev)
        for _ in range(760):
            st = engine3d.step(scd, st, ctrl)
        st_cpu = to_device(st, "cpu")
        card_cpu = {}
        for solver in engine3d.SOLVERS3:
            engine3d.SOLVER3 = solver
            a = engine3d.step(scd, st, ctrl)
            b = engine3d.step(sc2, st_cpu, ctrl.cpu())
            err = max(float((getattr(a, f).cpu() - getattr(b, f)).abs().max()
                            / max(float(getattr(b, f).abs().max()), 1e-12))
                      for f in ("pos", "quat", "vel", "om", "q", "qd"))
            card_cpu[solver] = err
            check(err < 1e-5, f"one {solver} step card vs CPU: {err:.3g}")
        print(f"  one step card vs CPU (largest difference relative to each "
              f"state leaf's largest entry): {card_cpu}; rollout_trace3d "
              f"{tuple(tr.shape)} ({tr_steps} steps, every 20; 800 before "
              f"the time limit's cut)", flush=True)
        out["pure"] = {"profile": pure, "eval": dict(eval_st, seconds=ev_s),
                       "cost": cost, "card_vs_cpu": card_cpu}
    finally:
        engine3d.SOLVER3 = old
    out["seconds"] = time.perf_counter() - t_phase
    return out


def pipeline_line(what: str, out: dict) -> str:
    """The datagen CLI's summed pipeline figures, printable."""
    parts = out["kernel_s"] + out["bake_s"] + out["write_s"]
    return (f"{what}: {out['rollouts']:,} rollouts in {out['seconds']:.2f}s "
            f"of pipeline ({out['rollouts'] / out['seconds']:,.0f} "
            f"rollouts/s; CLI wall {out['wall_s']:.2f}s), {out['waves']} "
            f"waves; summed kernel {out['kernel_s']:.2f}s + bake "
            f"{out['bake_s']:.2f}s + write {out['write_s']:.2f}s = "
            f"{parts:.2f}s; card busy {out['kernel_s'] / out['seconds']:.1%} "
            f"of the wall, idle {out['gap_s']:.3f}s between kernels; host "
            f"waited {out['wait_s']:.2f}s for results; "
            f"{out['drains_under_kernel']} drains ended under the next "
            f"wave's kernel")


def phase_train_path(dev, k2_wave_ms: float) -> dict:
    """Phase 9: datagen CLIs -> trainers -> sample CLI on their checkpoint
    directories. ``k2_wave_ms``: phase 5's K2 time at the same 8 x 9,088 x
    800 shape (grippers 0-7 x mug_small), the kernel-alone time of one 3D
    wave. Returns the numbers for the summary."""
    import torch

    from dgdm_tpu_torch.cli import datagen as datagen_cli
    from dgdm_tpu_torch.cli import datagen3d as datagen3d_cli
    from dgdm_tpu_torch.cli import sample as sample_cli
    from dgdm_tpu_torch.cli import train_diffusion, train_dynamics
    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d, rollout3d
    from dgdm_tpu_torch.train import checkpoints
    from dgdm_tpu_torch.train.data import DynamicsData, to_device
    from dgdm_tpu_torch.train.dynamics import DynamicsTrainer

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(*a):
            return os.path.join(tmp, *a)

        for mod, k in ((rollout2d, "rollout2d"), (rollout3d, "rollout3d")):
            mod.KERNEL_LAUNCHES[k] = 0
        t_phase = time.perf_counter()
        # (a) 2D datagen: 4 training icons and a validation icon
        a = datagen_cli.main(["--num_objects", "4", "--num_fingers", "32",
                              "--pairs_per_batch", "32",
                              "--save_dir", path("data"), "--device", "cuda"])
        a_val = datagen_cli.main(["--object_start", "4", "--num_objects", "1",
                                  "--num_fingers", "32",
                                  "--pairs_per_batch", "32",
                                  "--save_dir", path("val"),
                                  "--device", "cuda"])
        # (b) 3D datagen: mug_small x 16 grippers in two blocks of 8
        b = datagen3d_cli.main([
            "--object_dir", os.path.join(ROOT, "tests", "fixtures",
                                         "scanned_objects"),
            "--num_objects", "1", "--num_fingers", "16",
            "--pairs_per_batch", "8", "--save_dir", path("data3d"),
            "--device", "cuda"])
        dg_launches = {"rollout2d": rollout2d.KERNEL_LAUNCHES["rollout2d"],
                       "rollout3d": rollout3d.KERNEL_LAUNCHES["rollout3d"]}
        # (c) the classifier at full width, bf16, 4 pairs a step
        c = train_dynamics.main(["--data_dir", path("data"),
                                 "--test_data_dir", path("val"),
                                 "--save_dir", path("dyn"),
                                 "--batch_size", "4", "--num_epochs", "2",
                                 "--device", "cuda"])
        # (d) the diffusion UNet
        d = train_diffusion.main(["--num_fingers", "20480",
                                  "--batch_size", "2048", "--num_epochs", "2",
                                  "--save_dir", path("diff"),
                                  "--device", "cuda"])
        # (e) the design loop on the two checkpoint directories
        t0 = time.perf_counter()
        e = sample_cli.main([
            "--diffusion_checkpoint_path", path("diff", "ckpt", "last"),
            "--checkpoint_path", path("dyn", "ckpt", "best"),
            "--save_dir", path("guided"), "--batch_size", "16",
            "--grid_size", "360", "--num_pos", "5",
            "--num_inference_steps", "5", "--num_test_objects", "1",
            "--objectives", "shift_up", "--device", "cuda"])
        torch.cuda.synchronize()
        sample_s = time.perf_counter() - t0
        phase_s = time.perf_counter() - t_phase
        launches = {"rollout2d": rollout2d.KERNEL_LAUNCHES["rollout2d"],
                    "rollout3d": rollout3d.KERNEL_LAUNCHES["rollout3d"]}
        check(launches["rollout2d"] >= 6 and launches["rollout3d"] >= 2,
              f"data-to-checkpoint path launches {launches}: K1 >= 6 and "
              f"K2 >= 2 expected")
        check(dg_launches == {"rollout2d": 5, "rollout3d": 2},
              f"datagen CLIs' launches {dg_launches}: 5 K1 waves and 2 K2 "
              f"blocks expected")
        shards = sorted(os.listdir(path("data")))
        check(len(shards) == 128 and len(os.listdir(path("val"))) == 32,
              f"128 + 32 2D shards, found {len(shards)}")
        check(b["pairs"] == 16, f"3D pairs {b['pairs']}")
        check(len(os.listdir(path("data3d"))) == b["pairs_valid"],
              "one 3D shard a kept pair")
        for k in ("first_loss", "last_loss", "best_val_loss"):
            check(np.isfinite(c[k]), f"train_dynamics {k} {c[k]}")
        for k in ("first_loss", "last_loss"):
            check(np.isfinite(d[k]), f"train_diffusion {k} {d[k]}")
        smp = np.load(path("guided", f"samples_shift_up_"
                           f"{next(iter(e['shift_up']['objects']))}.npy"))
        check(smp.shape == (16, 14, 1) and np.isfinite(smp).all(),
              "finite (16, 14, 1) samples from the trained checkpoints")

        print(pipeline_line("(a) cli.datagen, 4 icons x 32 grippers", a),
              flush=True)
        check(a["seconds"] < a["kernel_s"] + a["bake_s"] + a["write_s"],
              "2D datagen pipeline: no overlap of host and card work")
        # the stream-order trap: a wave's result copy queued behind the next
        # wave's kernel makes its drain end only after that kernel, and the
        # next bake then runs while the card idles. One gripper block of 4
        # icons: each of the first 3 drains must end under the next kernel.
        check(a["drains_under_kernel"] == a["waves"] - 1,
              f"2D datagen pipeline: {a['drains_under_kernel']} of "
              f"{a['waves'] - 1} drains ended while the next kernel ran")
        print(pipeline_line("    validation icon 4 x 32 grippers", a_val),
              flush=True)
        print(pipeline_line("(b) cli.datagen3d, mug_small x 16 grippers", b)
              + f"; gave up on {b['pairs'] - b['pairs_valid']} of "
              f"{b['pairs']} pairs; K2 alone on one such wave "
              f"{k2_wave_ms:.1f} ms (phase 5)", flush=True)
        print(f"(c) cli.train_dynamics: {c['steps']} steps of 36,000 rows, "
              f"{c['rows_per_second']:,.0f} rows/s over the iterations "
              f"(StepTimer EWMA {c['rows_per_second_ewma']:,.0f}), loss "
              f"{c['first_loss']:.4f} -> {c['last_loss']:.4f}, best val "
              f"{c['best_val_loss']:.4f}; host batch loading "
              f"{c['data_s']:.2f}s of the iterations' {c['loop_s']:.2f}s "
              f"({c['train_s']:.2f}s with validation and checkpoints)",
              flush=True)
        print(f"(d) cli.train_diffusion: {d['steps']} steps of 2,048, "
              f"{d['grippers_per_second']:,.0f} grippers/s over the "
              f"iterations (StepTimer EWMA "
              f"{d['grippers_per_second_ewma']:,.0f}), loss "
              f"{d['first_loss']:.4f} -> {d['last_loss']:.4f}; batch "
              f"gathering {d['data_s']:.3f}s of the iterations' "
              f"{d['loop_s']:.2f}s ({d['train_s']:.2f}s with validation and "
              f"checkpoints); the procedural set built and uploaded once in "
              f"{d['setup_s']:.2f}s", flush=True)
        print(f"(e) cli.sample on ckpt/best + ckpt/last: {sample_s:.1f}s "
              f"(verification {e['verification']['seconds']:.1f}s); phase "
              f"{phase_s:.1f}s; kernel launches {launches} ({dg_launches} "
              f"of them by the datagen CLIs)", flush=True)

        # ---- outside the counted run: spot check, K1 alone, bf16 ---------
        rec = np.load(path("data", "0_5.npz"), allow_pickle=True)["arr_0"] \
            .item()
        contour = extract_contours(synthetic_icon(0))
        one = datagen.stack_scenes([engine2d.make_scene(
            *sample_gripper_2d(5), contour)])
        poses = torch.as_tensor(datagen.pad_poses(engine2d.pose_grid()),
                                device=dev)
        dth, dpos, _, _ = rollout2d.profile_batch(
            *rollout2d.scene_arrays(one, device=dev), poses)
        check(np.array_equal(rec["delta_theta"], dth[0, :9000].cpu().numpy())
              and np.array_equal(rec["delta_pos"][:, :2],
                                 dpos[0, :9000].cpu().numpy()),
              "shard 0_5 differs from rollout2d.profile_batch of its pair")
        check(float(np.abs(rec["delta_theta"]).max()) > 1e-2,
              "shard 0_5: nothing moved")
        wave = rollout2d.scene_arrays(datagen.stack_scenes([
            engine2d.make_scene(*sample_gripper_2d(i), contour)
            for i in range(32)]), device=dev)
        k1_wave_ms, _ = timed_cuda(lambda: rollout2d.rollout(*wave, poses),
                                   reps=2)
        print(f"  shard 0_5 bitwise equal to rollout2d.profile_batch of its "
              f"pair; K1 alone on one 32-pair wave {k1_wave_ms:.1f} ms "
              f"({32 * 9000 / k1_wave_ms * 1e3:,.0f} rollouts/s)", flush=True)

        batch = to_device(next(DynamicsData(path("data")).batches(
            4, np.random.RandomState(0))), dev)
        losses = {}
        # the training CLIs allow TF32; the float32 step must not use it
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for bf16 in (False, True):
            tr = DynamicsTrainer(ProfileForward2D(), bf16=bf16, device=dev)
            checkpoints.restore(path("dyn", "ckpt", "last"), tr)
            g = torch.Generator(device=dev).manual_seed(7)
            t = torch.randint(0, 15, (batch["ctrl"].shape[0],), generator=g,
                              device=dev)
            noise = torch.randn(batch["ctrl"].shape, generator=g, device=dev)
            losses[bf16] = float(tr.step(batch, t, noise)["loss"])
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        print(f"  one classifier step from ckpt/last: loss float32 "
              f"{losses[False]:.6f}, bfloat16 {losses[True]:.6f} "
              f"(relative {rel:.2e})", flush=True)
        check(0 < rel < 1e-2, f"bf16 vs f32 loss relative {rel}: within "
              f"1e-2, and not 0 (autocast must have taken effect)")
    out.update(datagen_2d=a, datagen_2d_val=a_val, datagen_3d=b,
               train_dynamics=c, train_diffusion=d, sample_s=sample_s,
               verification_s=e["verification"]["seconds"],
               phase_s=phase_s, launches=launches, dg_launches=dg_launches,
               k1_wave_ms=k1_wave_ms,
               k2_wave_ms=k2_wave_ms, bf16_loss=losses[True],
               f32_loss=losses[False])
    return out


# ---- 12. multi-GPU: the flagship step, two ranks on one card, NCCL --------

P12_STEPS = 4
P12_SAMPLE_ARGS = ["--batch_size", "16", "--grid_size", "360", "--num_pos",
                   "5", "--num_inference_steps", "5", "--num_test_objects",
                   "1", "--objectives", "shift_up", "--device", "cuda"]


def p12_fixed_samples():
    """The fixed normalized samples that 12 (b)'s verification calls
    evaluate: 16 2D grippers and 16 3D ones from seed 12."""
    rs = np.random.RandomState(12)
    return (rs.uniform(-0.5, 0.5, (16, 14)).astype(np.float32),
            rs.uniform(-0.5, 0.5, (16, 42)).astype(np.float32))


def p12_steps(tmp: str, out: dict, with_sample: bool) -> None:
    """12 (b)'s calls in order, in ``tmp``: the datagen CLI, both training
    CLIs, (``with_sample``) the sample CLI on the trainers' checkpoints,
    and the verification calls on fixed samples; the launches and seconds
    of each into ``out``. Ranks and the one-rank reference run the same
    code. Grippers 8-15 of both icons become the validation set, 0-7 of
    both the training set, so that the objects of a batch differ: with one
    object for all rows, the object encoder's gradient is rounding noise
    (see tests/test_torch_training.null_biases) and Adam turns it into
    steps of the learning rate in random directions on each process."""
    import torch
    import torch.distributed as dist

    from dgdm_tpu_torch.cli import datagen as datagen_cli
    from dgdm_tpu_torch.cli import sample as sample_cli
    from dgdm_tpu_torch.cli import train_diffusion, train_dynamics
    from dgdm_tpu_torch.eval.simeval import sim_eval_batch_2d
    from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
    from dgdm_tpu_torch.geom import mesh3d
    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.parallel.distributed import rank
    from dgdm_tpu_torch.sim import rollout2d, rollout3d

    def path(*a):
        return os.path.join(tmp, *a)

    def step(name, fn):
        before = (rollout2d.KERNEL_LAUNCHES["rollout2d"],
                  rollout3d.KERNEL_LAUNCHES["rollout3d"])
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out.setdefault("seconds", {})[name] = time.perf_counter() - t0
        out.setdefault("launches", {})[name] = {
            "rollout2d": rollout2d.KERNEL_LAUNCHES["rollout2d"] - before[0],
            "rollout3d": rollout3d.KERNEL_LAUNCHES["rollout3d"] - before[1]}
        return res

    for k in rollout2d.KERNEL_LAUNCHES:
        rollout2d.KERNEL_LAUNCHES[k] = 0
    for k in rollout3d.KERNEL_LAUNCHES:
        rollout3d.KERNEL_LAUNCHES[k] = 0
    out["datagen"] = step("datagen", lambda: datagen_cli.main([
        "--num_objects", "2", "--num_fingers", "16", "--pairs_per_batch",
        "16", "--save_dir", path("data"), "--device", "cuda"]))
    if rank() == 0:
        os.makedirs(path("val"))
        for name in os.listdir(path("data")):
            if int(name.split("_")[1].split(".")[0]) >= 8:
                os.replace(path("data", name), path("val", name))
    if dist.is_initialized():
        dist.barrier()
    # float32 (the CLIs' TF32 products), full width, 4 steps of 4 pairs
    out["dynamics"] = step("train_dynamics", lambda: train_dynamics.main([
        "--data_dir", path("data"), "--test_data_dir", path("val"),
        "--save_dir", path("dyn"), "--batch_size", "4", "--num_epochs", "1",
        "--no_bf16", "--device", "cuda"]))
    out["diffusion"] = step("train_diffusion", lambda: train_diffusion.main([
        "--num_fingers", "10240", "--batch_size", "2048", "--num_epochs",
        "1", "--save_dir", path("diff"), "--device", "cuda"]))
    if with_sample:
        out["sample"] = step("sample", lambda: sample_cli.main([
            "--diffusion_checkpoint_path", path("diff", "ckpt", "last"),
            "--checkpoint_path", path("dyn", "ckpt", "last"),
            "--save_dir", path("guided")] + P12_SAMPLE_ARGS))
    s2, s3 = p12_fixed_samples()
    contour = extract_contours(synthetic_icon(0))
    out["eval2d"] = step("sim_eval_batch_2d", lambda: sim_eval_batch_2d(
        s2, [contour], num_rot=360, device="cuda"))
    mug = mesh3d.load_obj(MUG)
    out["eval3d"] = step("sim_eval_batch_3d", lambda: sim_eval_batch_3d(
        s3, [mug], num_rot=45, total_steps=2400, regrasp_every=800,
        device="cuda"))
    out["total_launches"] = {
        "rollout2d": rollout2d.KERNEL_LAUNCHES["rollout2d"],
        "rollout3d": rollout3d.KERNEL_LAUNCHES["rollout3d"]}


def phase12_rank(tmp: str) -> dict:
    """One of 12 (b)'s ranks (started by ``dgdm_tpu_torch.parallel.launch``
    with gloo, both on cuda:0): the CLIs' normal ``main(argv)`` in the
    shared directory ``tmp``."""
    import torch

    from dgdm_tpu_torch.parallel.distributed import rank, world_size

    out = {"rank": rank(), "world": world_size(),
           "device": str(torch.cuda.current_device())}
    p12_steps(tmp, out, with_sample=True)
    return out


def phase12_nccl() -> dict:
    """12 (c): a one-rank NCCL group on the card: one all-reduce and one
    step of a DDP-wrapped DynamicsTrainer, beside the same step without a
    group."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.parallel.mesh import data_parallel_mesh
    from dgdm_tpu_torch.train.dynamics import DynamicsTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = dist.get_backend()
    t = torch.full((4,), 3.0, device="cuda")
    dist.all_reduce(t)
    rs = np.random.RandomState(0)
    rows = 4096
    batch = {"ctrl": rs.uniform(-1, 1, (rows, 14)),
             "ori": rs.uniform(-1, 1, (rows, 1)),
             "pos": rs.uniform(-1, 1, (rows, 2)),
             "obj": rs.uniform(-1, 1, (rows, 200)),
             "score": rs.randn(rows, 3)}
    losses = {}
    for name, mesh in (("ddp", data_parallel_mesh(min_devices=1)),
                       ("plain", None)):
        torch.manual_seed(0)
        tr = DynamicsTrainer(ProfileForward2D(), device="cuda", mesh=mesh)
        if name == "ddp":
            wrapped = isinstance(tr.net, DistributedDataParallel)
        losses[name] = float(tr.train_step(batch)["loss"])
    return {"backend": backend, "all_reduce": t.cpu().tolist(),
            "ddp": wrapped, "losses": losses}


def p12_state(path: str, key: str) -> dict:
    import torch

    st = torch.load(os.path.join(path, "train_state.pt"), map_location="cpu",
                    weights_only=True)
    return {k: v.numpy() for k, v in st[key].items()}


BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def p12_close(a: dict, b: dict, atol: float, what: str) -> dict:
    """Parameters within ``atol``, the bar of tests/test_multichip.py, which
    holds the parameters and not the BatchNorm statistics -> max |diff| of
    the parameters and of the running statistics, and the three
    parameters that differ most. Adam moves an element by about the
    learning rate a step whatever its gradient, so where the gradient is
    rounding noise (the biases before a BatchNorm; the object encoder,
    whose gradients from a batch's two objects cancel under the BatchNorm
    after it) two correct runs drift apart at that scale: the losses and
    the bitwise checks are the sharper ones."""
    err = {"params": 0.0, "stats": 0.0}
    per = {}
    for k, v in b.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = float(np.abs(a[k] - v).max())
        kind = "stats" if k.endswith(BUFFERS) else "params"
        err[kind] = max(err[kind], d)
        if kind == "params":
            per[k] = d
    err["top"] = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    check(err["params"] <= atol, f"{what}: max |diff| "
          f"{err['params']:.3g} > {atol} ({err['top']})")
    return err


def p12_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_multi_gpu(dev, card: str) -> dict:
    """Phase 12: (a) graft_entry.entry() at the flagship shape, (b) two
    ranks on cuda:0 over gloo through the CLIs, each step held against the
    same call in this process, (c) a one-rank NCCL group."""
    import torch

    from dgdm_tpu_torch import graft_entry
    from dgdm_tpu_torch.parallel import launch

    out: dict = {}
    t_phase = time.perf_counter()
    # ---- (a) the flagship guided-denoise step, the card to itself -------
    fn, (x, obj) = graft_entry.entry(device="cuda")
    ms, y = timed_cuda(lambda: fn(x, obj), reps=20)
    cfn, (cx, cobj) = graft_entry.entry(device="cpu")
    t0 = time.perf_counter()
    cy = cfn(cx, cobj)
    cpu_s = time.perf_counter() - t0
    err = float((y.cpu() - cy).abs().max())
    moved = float((y - x).abs().max())
    check(torch.isfinite(y).all() and tuple(y.shape) == (16, 14, 1),
          "entry(): finite (16, 14, 1) output")
    check(moved > 1e-3, f"entry(): the step moved x by {moved}")
    check(err <= 1e-5, f"entry() card vs CPU max |diff| {err:.3g}")
    out["entry"] = {"ms": ms, "steps_per_s": 1e3 / ms,
                    "cpu_vs_card_max_abs_err": err, "cpu_s": cpu_s}
    print(f"12 (a) graft_entry.entry(): guided-denoise step at the "
          f"flagship shape (B 16, 9,000 poses, UNet (128, 256), "
          f"classifier width 256, float32, TF32 off) {ms:.2f} "
          f"ms/step, {1e3 / ms:.2f} steps/s (CUDA events, 20 calls "
          f"after a warm-up) on {card}; card vs CPU max |diff| "
          f"{err:.2e} (CPU {cpu_s:.1f}s)", flush=True)

    with tempfile.TemporaryDirectory() as tmp2, \
            tempfile.TemporaryDirectory() as tmp1:
        # ---- (b) the ranks, and the one-rank references meanwhile in this
        # process (they share the card: no rank's seconds are a scaling
        # figure)
        ranks = launch.start(2, "chip_smoke:phase12_rank", {"tmp": tmp2},
                             backend="gloo", threads=2, timeout=600)
        try:
            ref: dict = {}
            p12_steps(tmp1, ref, with_sample=False)
            outs = ranks.wait()
        except BaseException:
            ranks.stop()
            raise
        ranks_s = time.perf_counter() - ranks.t0
        # the sample CLI on the ranks' checkpoints, one rank
        t0 = time.perf_counter()
        from dgdm_tpu_torch.cli import sample as sample_cli

        ref_sample = sample_cli.main([
            "--diffusion_checkpoint_path", os.path.join(tmp2, "diff", "ckpt",
                                                        "last"),
            "--checkpoint_path", os.path.join(tmp2, "dyn", "ckpt", "last"),
            "--save_dir", os.path.join(tmp1, "guided")] + P12_SAMPLE_ARGS)
        ref["seconds"]["sample"] = time.perf_counter() - t0
        check([o["world"] for o in outs] == [2, 2] and
              {o["device"] for o in outs} == {"0"},
              f"two ranks on cuda:0: {[(o['world'], o['device']) for o in outs]}")
        # datagen: the shards, written once by rank 0, bitwise the
        # one-rank run's
        names = {d: sorted(os.listdir(os.path.join(tmp2, d)))
                 for d in ("data", "val")}
        for d in ("data", "val"):
            check(names[d] == sorted(os.listdir(os.path.join(tmp1, d)))
                  and len(names[d]) == 16, f"12 (b) {d} shards {names[d]}")
            for name in names[d]:
                a = np.load(os.path.join(tmp2, d, name),
                            allow_pickle=True)["arr_0"].item()
                b = np.load(os.path.join(tmp1, d, name),
                            allow_pickle=True)["arr_0"].item()
                for k in b:
                    check(np.array_equal(a[k], b[k]),
                          f"12 (b) shard {d}/{name}: {k} differs")
        # trainers: every rank the same losses; within the bars of
        # tests/test_multichip.py of the one-rank run
        for o in outs[1:]:
            check(o["dynamics"]["last_loss"] == outs[0]["dynamics"]
                  ["last_loss"] and o["diffusion"]["last_loss"] ==
                  outs[0]["diffusion"]["last_loss"], "ranks' losses differ")
        o = outs[0]
        check(o["dynamics"]["steps"] == ref["dynamics"]["steps"] == P12_STEPS
              and o["diffusion"]["steps"] == ref["diffusion"]["steps"]
              == P12_STEPS, f"{P12_STEPS} steps of each trainer")
        loss_rel = max(p12_rel(o[m][k], ref[m][k])
                       for m in ("dynamics", "diffusion")
                       for k in ("first_loss", "last_loss"))
        check(loss_rel <= 2e-4, f"12 (b) losses 2 ranks vs 1: {loss_rel:.3g}")
        dyn = p12_close(
            p12_state(os.path.join(tmp2, "dyn", "ckpt", "last"), "model"),
            p12_state(os.path.join(tmp1, "dyn", "ckpt", "last"), "model"),
            5e-4, "12 (b) dynamics parameters")
        ema = p12_close(
            p12_state(os.path.join(tmp2, "diff", "ckpt", "last"), "ema"),
            p12_state(os.path.join(tmp1, "diff", "ckpt", "last"), "ema"),
            5e-4, "12 (b) diffusion EMA parameters")
        # the sp-sharded design loop against one rank on the same
        # checkpoints
        sample_err = 0.0
        files = sorted(f for f in os.listdir(os.path.join(tmp1, "guided"))
                       if f.endswith(".npy"))
        check(files == sorted(f for f in os.listdir(
            os.path.join(tmp2, "guided")) if f.endswith(".npy"))
            and len(files) == 2, f"12 (b) sample files {files}")
        for f in files:
            a = np.load(os.path.join(tmp2, "guided", f))
            b = np.load(os.path.join(tmp1, "guided", f))
            check(a.shape == (16, 14, 1) and np.isfinite(a).all(), f)
            sample_err = max(sample_err, float(np.abs(a - b).max()))
        check(sample_err <= 1e-5, f"12 (b) samples, sp = 2 vs one rank: "
              f"max |diff| {sample_err:.3g}")
        # verification on fixed samples: every metric bitwise
        for k in ("eval2d", "eval3d"):
            for oo in outs:
                check(len(oo[k]) == len(ref[k]) == 16, k)
                for ma, mb in zip(oo[k], ref[k]):
                    for m in mb:
                        check(np.array_equal(ma[m], mb[m]),
                              f"12 (b) {k} rank {oo['rank']}: {m} differs")
        for oo in outs:
            la = oo["launches"]
            check(la["sim_eval_batch_2d"] == {"rollout2d": 1, "rollout3d": 0}
                  and la["sim_eval_batch_3d"] == {"rollout2d": 0,
                                                  "rollout3d": 1}
                  and la["datagen"]["rollout2d"] == 2,
                  f"12 (b) rank {oo['rank']} launches {la}")
            print(f"12 (b) rank {oo['rank']}/2 on cuda:{oo['device']} "
                  f"(gloo): launches " + ", ".join(
                      f"{s} K1 {v['rollout2d']} K2 {v['rollout3d']}"
                      for s, v in la.items()) + "; seconds " + ", ".join(
                      f"{s} {v:.2f}" for s, v in oo["seconds"].items()),
                  flush=True)
        print(f"12 (b) one rank (this process): seconds " + ", ".join(
            f"{s} {v:.2f}" for s, v in ref["seconds"].items()), flush=True)
        print(f"12 (b) 2 ranks vs 1: datagen shards bitwise ({len(names['data'])}"
              f" + {len(names['val'])}); losses max rel {loss_rel:.2e}; "
              f"dynamics parameters max |diff| {dyn['params']:.2e} (most: "
              + ", ".join(f"{k} {v:.2e}" for k, v in dyn["top"]) +
              f"; BatchNorm running statistics {dyn['stats']:.2e}), "
              f"diffusion EMA "
              f"{ema['params']:.2e}; samples (sp = 2) max |diff| {sample_err:.2e}; "
              f"verification metrics bitwise (2D 16 x 360 x 8,000, 3D 16 x "
              f"45 x 2,400); ranks {ranks_s:.1f}s from start", flush=True)
        out["ranks"] = [{k: oo[k] for k in ("rank", "seconds", "launches",
                                             "total_launches")}
                        for oo in outs]
        out["reference_seconds"] = ref["seconds"]
        out["ref_sample_s"] = ref["seconds"]["sample"]
        out.update(loss_rel=loss_rel, dynamics_err=dyn, ema_err=ema,
                   sample_err=sample_err, ranks_s=ranks_s,
                   design_sweep=ref_sample.get("design_sweep"))

    # ---- (c) a one-rank NCCL group ----------------------------------------
    t0 = time.perf_counter()
    (nc,) = launch.run(1, "chip_smoke:phase12_nccl", backend="nccl",
                       threads=2, timeout=300)
    nccl_s = time.perf_counter() - t0
    check(nc["backend"] == "nccl" and nc["all_reduce"] == [3.0] * 4 and
          nc["ddp"], f"12 (c) NCCL group: {nc}")
    nrel = p12_rel(nc["losses"]["ddp"], nc["losses"]["plain"])
    check(np.isfinite(nc["losses"]["ddp"]) and nrel <= 1e-5,
          f"12 (c) DDP step loss {nc['losses']} (relative {nrel:.3g})")
    print(f"12 (c) one-rank NCCL group: all_reduce {nc['all_reduce']}, a "
          f"DDP-wrapped DynamicsTrainer step (width 256, 4,096 rows) loss "
          f"{nc['losses']['ddp']:.6f} vs {nc['losses']['plain']:.6f} without "
          f"a group (relative {nrel:.2e}); {nccl_s:.1f}s with the process "
          f"start. One card runs no NCCL group of two ranks (NCCL refuses "
          f"two ranks on one device) and shows no scaling", flush=True)
    out["nccl"] = {**nc, "seconds": nccl_s, "loss_rel": nrel}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# the render path's trace bars (theta or quaternion components, and
# positions and finger slides in m), from
# ``JAX_PLATFORMS=cpu python scripts/probe_trace_chaos.py``: a 1-ulp change
# of the initial orientation moves these traces by at most 2.62e-5 rad and
# 8.6e-7 m (2D, 400 steps) and 9e-8 (3D, 800 steps)
TRACE_ANGLE_BAR, TRACE_POS_BAR = 1e-4, 1e-5


def design_pairs(report: dict, save_dir: str, objects: dict,
                 fingers_3d: bool) -> list:
    """The (objective, object) pairs of a ``cli.sample`` run as its
    ``--render_video`` picks them (``cli.sample.render_pair``), from its
    report and ``samples_*.npy``; ``objects`` maps each object id to its
    contour (2D) or (verts, faces) mesh (3D)."""
    from dgdm_tpu_torch.cli.sample import render_pair

    return [render_pair(objective, oid, np.load(os.path.join(
        save_dir, f"samples_{objective}_{oid}.npy")), te, objects[oid],
        fingers_3d)
        for objective, entry in report.items()
        for oid, te in entry.get("objects", {}).items()]


def trace_bars(what: str, out, ref, angle_cols, pos_cols) -> dict:
    """Traces (pairs, rows, columns) within the render path's bars."""
    err = np.abs(np.asarray(out, np.float64) - ref).reshape(
        -1, out.shape[-1]).max(0)
    ang, pos = float(err[angle_cols].max()), float(err[pos_cols].max())
    check(ang <= TRACE_ANGLE_BAR and pos <= TRACE_POS_BAR,
          f"{what}: max angle error {ang:.3g} (bar {TRACE_ANGLE_BAR}), "
          f"position {pos:.3g} m (bar {TRACE_POS_BAR})")
    print(f"  {what}: max angle error {ang:.3g} (bar {TRACE_ANGLE_BAR:g}), "
          f"position and slides {pos:.3g} m (bar {TRACE_POS_BAR:g}); bitwise "
          f"{bool(np.array_equal(out, ref))}", flush=True)
    return {"angle": ang, "pos": pos, "bitwise": bool(np.array_equal(out,
                                                                     ref))}


def phase_render(dev, pairs2d: list, pairs3d: list) -> dict:
    """Phase 13: the device part of ``cli.sample --render_video`` on the
    card: (a) the denoise trajectory at phase 4's shape, (b) one batched 2D
    trace of phase 4's design pairs through ``cli.sample.render_inputs``
    (depth cut from 8,000 to 2,000 steps), (c) its frames and silhouettes on
    the host, (d) one batched 3D trace of phase 7's pairs (800 steps), (e)
    the writers' files and the CPU tests that hold them."""
    import torch

    from dgdm_tpu_torch.cli import sample as sample_cli
    from dgdm_tpu_torch.eval import viz
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
    from dgdm_tpu_torch.sim import datagen, engine2d, engine3d
    from dgdm_tpu_torch.sim.types import to_device
    from dgdm_tpu_torch.train import generator

    out: dict = {}
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # ---- (a) the denoise trajectory at phase 4's shape ---------------------
    torch.manual_seed(0)
    unet = ConditionalUnet1D(input_dim=1, down_dims=(128, 256))
    noise = torch.as_tensor(np.random.RandomState(0).randn(16, 14, 1)
                            .astype(np.float32))
    unet_d = unet.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, traj = generator.sample_trajectory(unet_d, noise.to(dev), 15, 5)
    torch.cuda.synchronize()
    traj_s = time.perf_counter() - t0
    ref = generator.sample(unet_d, noise.to(dev), 15, 5)
    check(traj.shape == (6, 16, 14, 1) and torch.equal(traj[-1], ref)
          and torch.equal(last, ref),
          "13 (a) the trajectory's last row is generator.sample's, bitwise")
    cpu_traj = generator.sample_trajectory(unet.cpu(), noise, 15, 5)[1]
    traj_err = float((traj.cpu() - cpu_traj).abs().max())
    check(traj_err <= 1e-5, f"13 (a) card vs CPU {traj_err:.3g} > 1e-5")
    print(f"13 (a) denoise trajectory B 16 x 14 x 5 DDIM steps, UNet (128, "
          f"256), TF32 off: {traj_s * 1e3:.1f} ms; last row bitwise "
          f"generator.sample's; card vs CPU {traj_err:.3g} (bar 1e-5)",
          flush=True)
    out["trajectory"] = {"seconds": traj_s, "card_vs_cpu": traj_err}

    # ---- (b) the 2D traces of phase 4's design pairs -----------------------
    steps, every, regrasp = RENDER_2D_STEPS, 20, 200
    full_steps = sample_cli.render_schedule(False)[0]
    items, timing = sample_cli.render_inputs(pairs2d, False, dev, steps,
                                             every, regrasp, grid_size=360)
    tr = np.stack([it["trace"] for it in items])
    check(tr.shape == (len(pairs2d), steps // every, 5)
          and np.isfinite(tr).all(),
          f"13 (b) finite ({len(pairs2d)}, {steps // every}, 5) traces: "
          f"{tr.shape}")
    turn = float(np.abs(tr[..., 2] - np.float32(math.pi)).max())
    check(turn > 1e-2, f"13 (b) the object did not move (max |dtheta| "
          f"{turn:.3g})")
    ms2 = 1e3 * timing["trace_s"] / steps
    n = len(pairs2d[0]["y"]) // 2
    scenes = [engine2d.make_scene(p["y"][:n], p["y"][n:], p["object"])
              for p in pairs2d]
    pose = torch.tensor([0.0, 0.0, math.pi], device=dev)
    sc = engine2d.expand_scene(to_device(datagen.stack_scenes(scenes), dev),
                               1)
    state = [engine2d.init_state(sc, pose[None])]
    ctrl = engine2d._squeeze_ctrl(dev)

    def step2():
        state[0] = engine2d.step(sc, state[0], ctrl)

    # the checks' own traces: a subset of the pairs, each alone on the card
    # and together on the CPU
    sel = [0, len(pairs2d) - 1]
    with torch.inference_mode():
        prof2 = step_profile(step2)
        t0 = time.perf_counter()
        alone = np.stack([engine2d.rollout_trace(
            to_device(scenes[i], dev), pose, steps=400, every=every,
            regrasp_every=regrasp).cpu().numpy() for i in sel])
        alone_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_items, _ = sample_cli.render_inputs([pairs2d[i] for i in sel], False,
                                            "cpu", 400, every, regrasp)
    cpu_s = time.perf_counter() - t0
    cpu_tr = np.stack([it["trace"] for it in cpu_items])
    print(f"13 (b) 2D render traces: {len(pairs2d)} design pairs of phase 4 "
          f"x {steps} steps (cut from {full_steps}; 2,000 before the time "
          f"limit's cut), every {every}, regrasp "
          f"every {regrasp}, one batched trace on the card: "
          f"{timing['trace_s']:.2f}s, {ms2:.2f} ms a step; "
          f"{prof2['kernels_per_step']:.0f} CUDA kernels a step, the card "
          f"busy {prof2['busy_share']} (torch.profiler, 10 steps); "
          f"{full_steps} steps projected {ms2 * full_steps / 1e3:.1f}s; max "
          f"|theta - pi| {turn:.4f}", flush=True)
    print(f"  the checks' own traces: pairs {sel} of {len(pairs2d)} (all "
          f"{len(pairs2d)} before the time limit's cut), each alone x 400 "
          f"steps {alone_s:.2f}s on the card, together on the CPU x 400 "
          f"steps {cpu_s:.2f}s", flush=True)
    rows = 400 // every
    batched_vs_alone = trace_bars(
        f"13 (b) batched vs pairs {sel} alone on the card, 400 steps",
        tr[sel, :rows], alone, [2], [0, 1, 3, 4])
    card_vs_cpu = trace_bars(f"13 (b) card vs a CPU trace of pairs {sel}, "
                             f"400 steps", tr[sel, :rows], cpu_tr, [2],
                             [0, 1, 3, 4])
    out["trace_2d"] = {"pairs": len(pairs2d), "steps": steps,
                       "seconds": timing["trace_s"], "ms_per_step": ms2,
                       "projected_s_full_depth": ms2 * full_steps / 1e3,
                       "max_turn": turn, **prof2, "alone_pairs": sel,
                       "alone_s": alone_s,
                       "cpu_s": cpu_s,
                       "batched_vs_alone": batched_vs_alone,
                       "card_vs_cpu": card_vs_cpu}

    # ---- (c) frames and silhouettes on the host ----------------------------
    colours = {tuple(c) for c in viz.FRAME_COLORS}
    for it in items:
        fr = it["frames"]
        check(fr.shape == (steps // every, 128, 128, 3)
              and fr.dtype == np.uint8,
              f"13 (c) frames {fr.shape} {fr.dtype}")
        seen = {tuple(c) for c in np.unique(fr.reshape(-1, 3), axis=0)}
        first = {tuple(c) for c in np.unique(fr[0].reshape(-1, 3), axis=0)}
        check(seen <= colours and first == colours,
              "13 (c) frames use the four colours, frame 0 shows the object "
              "and both fingers")
        check(it["silhouettes"].shape == (10, 128, 128)
              and it["silhouettes"].any(), "13 (c) silhouettes")
    n_frames = sum(len(it["frames"]) for it in items)
    print(f"13 (c) frames and silhouettes on the host: {n_frames} frames of "
          f"128 x 128 and {len(items)} x 10 silhouettes, scenes included, "
          f"{timing['host_s']:.2f}s ({1e3 * timing['host_s'] / n_frames:.1f} "
          f"ms a frame)", flush=True)
    out["frames"] = {"frames": n_frames, "host_s": timing["host_s"]}

    # ---- (d) the 3D traces of phase 7's design pairs -----------------------
    steps3, every3, _ = sample_cli.render_schedule(True)
    items3, timing3 = sample_cli.render_inputs(pairs3d, True, dev, steps3,
                                               every3)
    tr3 = np.stack([it["trace"] for it in items3])
    check(tr3.shape == (len(pairs3d), 40, 9) and np.isfinite(tr3).all(),
          f"13 (d) finite (40, 9) traces: {tr3.shape}")
    qerr = float(np.abs(np.linalg.norm(tr3[..., 3:7], axis=-1) - 1).max())
    check(qerr <= 1e-4, f"13 (d) quaternion norms off by {qerr:.3g}")
    pose3 = torch.tensor([0.0, 0.0, 0.7], device=dev)
    sel3 = [0]
    t0 = time.perf_counter()
    with torch.inference_mode():
        alone3 = np.stack([engine3d.rollout_trace3d(to_device(
            engine3d.with_hgrid(engine3d.make_scene(
                pairs3d[i]["y"][:21], pairs3d[i]["y"][21:],
                *pairs3d[i]["object"])), dev), pose3,
            steps=steps3, every=every3).cpu().numpy() for i in sel3])
    alone3_s = time.perf_counter() - t0
    for p, it in zip(pairs3d, items3):
        for row in it["trace"][[0, -1]]:
            sets = viz.scene_points_3d(it["points"], it["com"], p["y"][:21],
                                       p["y"][21:], row)
            check(all(np.isfinite(s).all() for s in sets),
                  "13 (d) finite scene points")
    ms3 = 1e3 * timing3["trace_s"] / steps3
    print(f"13 (d) 3D render traces: {len(pairs3d)} design pairs of phase 7 "
          f"x {steps3} steps, every {every3}, one batched trace on the card: "
          f"{timing3['trace_s']:.2f}s, {ms3:.2f} ms a step (scenes and "
          f"height grids {timing3['host_s']:.2f}s on the host); quaternion "
          f"norms within {qerr:.3g} of 1; scene points finite; pairs {sel3} "
          f"of {len(pairs3d)} alone (all {len(pairs3d)} before the time "
          f"limit's cut) {alone3_s:.2f}s", flush=True)
    b3 = trace_bars(f"13 (d) batched vs pairs {sel3} alone on the card, "
                    f"{steps3} steps", tr3[sel3], alone3, [3, 4, 5, 6],
                    [0, 1, 2, 7, 8])
    out["trace_3d"] = {"pairs": len(pairs3d), "steps": steps3,
                       "seconds": timing3["trace_s"], "ms_per_step": ms3,
                       "quat_norm_err": qerr, "alone_pairs": sel3,
                       "alone_s": alone3_s,
                       "host_s": timing3["host_s"], "batched_vs_alone": b3}

    # ---- (e) the writers ---------------------------------------------------
    print("13 (e) writers (matplotlib, imageio; not on this host): "
          "denoise_steps.npy/.png; per pair 2D {objective}_{oid}_gripper.png, "
          "_profile.png, _final.png, _silhouettes.npy, _rollout.mp4 (.gif "
          "without an mp4 backend); 3D _scene.png, _profile.png, "
          "_rollout.mp4 (_rollout_final.png without one). Written and checked "
          "on the CPU by tests/test_torch_sample_cli_render.py and "
          "tests/test_torch_viz.py", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run on the "
              "card only", file=sys.stderr)
        return 2
    from dgdm_tpu_torch.core.config import SIM
    from dgdm_tpu_torch.eval.metrics import profile_metrics_2d
    from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
    from dgdm_tpu_torch.geom.fingers import sample_gripper_2d
    from dgdm_tpu_torch.sim import (datagen, engine2d, engine3d, rollout2d,
                                    rollout3d)
    from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref

    # phases 2-9 run the default configuration (phases 10 and 11 set
    # "jacobi" and restore it)
    engine2d.SOLVER = "newton"
    engine3d.SOLVER3 = "newton"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the training CLIs' metric sink mirrors to wandb where it is installed;
    # a measurement run writes nothing outside its temporary directories
    os.environ["WANDB_MODE"] = "disabled"
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()
    clock = PhaseClock()

    # ---- 1. the card and the build --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not readable"
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libraries = {"rollout2d": rollout2d.LIBRARY,
                 "rollout3d": rollout3d.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        builds = {k: pool.submit(lib.build, force=True)
                  for k, lib in libraries.items()}
        for k, fut in builds.items():
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"build: {len(libraries)} kernel source(s) in {build_s:.1f}s",
          flush=True)
    # K1's two instantiations: rollout2d_kernel<16, Solver>, Solver = 0
    # (Newton) and 1 (Jacobi)
    regs2 = ptxas_report("rollout2d", rollout2d.LIBRARY, n_kernels=2)
    inst = {k: [r for e, r in regs2.items() if f"ILi16ELi{k}EE" in e]
            for k in (0, 1)}
    check(all(len(v) == 1 for v in inst.values()),
          f"rollout2d: instantiations Solver = 0, 1 in the build log: {regs2}")
    # K2's three: rollout3d_kernel<32, Solver>, Solver = 0 (Newton), 1
    # (Jacobi), 2 (Newton with newton_tol)
    regs3 = ptxas_report("rollout3d", rollout3d.LIBRARY, n_kernels=3)
    inst3 = {k: [r for e, r in regs3.items() if f"ILi32ELi{k}EE" in e]
             for k in (0, 1, 2)}
    check(all(len(v) == 1 for v in inst3.values()),
          f"rollout3d: instantiations Solver = 0, 1, 2 in the build log: "
          f"{regs3}")
    # (registers, spill bytes) of each instantiation
    ptxas = {"rollout2d": inst[0][0], "rollout2d_jacobi": inst[1][0],
             "rollout3d": inst3[0][0], "rollout3d_jacobi": inst3[1][0],
             "rollout3d_newton_tol": inst3[2][0]}
    registers = {k: v[0] for k, v in ptxas.items()}
    check(max(registers.values()) <= 128,
          f"at most 128 registers a thread (two 256-thread or one 512-thread "
          f"block an SM): {registers}")
    for lib in libraries.values():
        lib.get()

    clock.done("1")
    # ---- 2. K1 datagen schedule at full size ------------------------------
    contour = extract_contours(synthetic_icon(0))
    scenes8 = datagen.stack_scenes(
        [engine2d.make_scene(*sample_gripper_2d(i), contour) for i in range(8)])
    arrs8 = rollout2d.scene_arrays(scenes8, device=dev)
    poses = torch.as_tensor(datagen.pad_poses(engine2d.pose_grid()),
                            device=dev)
    check(poses.shape == (9088, 3), "padded datagen grid")
    dg_ms, out = timed_cuda(lambda: rollout2d.rollout(*arrs8, poses), reps=5)
    dg_plan = dict(rollout2d.LAST_PLAN)
    print(f"  K1 datagen 8x9088x200: {chosen(rollout2d)}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = profile_batch_ref(*arrs8, poses)
    torch.cuda.synchronize()
    dg_plain_ms = 1e3 * (time.perf_counter() - t0)
    bitwise("K1 datagen 8x9088x200", out, ref, range(9))
    dg_bound, dg_bound_by = bound_ms(
        k1_flops(contour.shape[0], arrs8[2].shape[1], SIM.steps_2d,
                 out[6].cpu(), out[7].cpu()),
        k1_bytes(8, contour.shape[0], arrs8[2].shape[1], 9088))
    out_np = {k: v.cpu().numpy() for k, v in zip(NAMES, out)}
    ref_np = {k: v.cpu().numpy() for k, v in zip(NAMES, ref)}
    for k in NAMES:
        check(out_np[k].shape == (8, 9088), f"datagen {k} shape")
    dg_stats = parity(out_np, ref_np, "datagen 8x9088x200, kernel vs plain")
    dg_exact = float(np.mean(out_np["dth"] == ref_np["dth"]))
    rollouts = 8 * 9000
    print(f"  kernel {dg_ms:.2f} ms/call ({rollouts / dg_ms * 1e3:,.0f} "
          f"rollouts/s of the 9,000-pose grid), plain {dg_plain_ms:.0f} ms; "
          f"dtheta bitwise equal on {dg_exact:.4f} of lanes; full/cheap steps "
          f"per block {out_np['cfull'][:, ::128].mean():.1f}/"
          f"{out_np['ccheap'][:, ::128].mean():.2f}; bound {dg_bound:.2f} ms "
          f"({dg_bound_by})", flush=True)

    gold = np.load(os.path.join(ROOT, "tests", "fixtures",
                                "rollout2d_golden.npz"))
    garrs = [torch.as_tensor(gold[k], device=dev)
             for k in ("coefs", "contour", "support", "scalars")]
    gposes = torch.as_tensor(gold["poses"], device=dev)
    for sched in ("datagen", "eval"):
        steps, rg, snap = (int(v) for v in gold[f"{sched}_schedule"])
        g_out = rollout2d.rollout(*garrs, gposes, steps=steps,
                                  regrasp_every=rg, snapshot_step=snap)
        parity({k: v.cpu().numpy() for k, v in zip(NAMES, g_out)},
               {k: gold[f"{sched}_{k}"] for k in NAMES},
               f"golden {sched} ({steps} steps), kernel vs TPU kernel")

    clock.done("2")
    # ---- 3. K1 eval schedule: 16 pairs x 360 orientations x 8,000 steps ---
    # host work of one verification call (scene builds of 16 new grippers,
    # their upload, and the per-gripper metrics below), timed beside K1
    ys = [sample_gripper_2d(100 + i) for i in range(16)]
    t0 = time.perf_counter()
    scenes16 = datagen.stack_scenes(
        [engine2d.make_scene(yl, yr, contour) for yl, yr in ys])
    arrs16 = rollout2d.scene_arrays(scenes16, device=dev)
    torch.cuda.synchronize()
    host_scene_s = time.perf_counter() - t0
    thetas = (np.linspace(-1.0, 1.0, 360) * np.pi + np.pi).astype(np.float32)
    th_p = datagen.pad_poses(thetas[:, None])[:, 0]
    eposes = torch.as_tensor(
        np.stack([np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1),
        device=dev)
    ekw = dict(steps=SIM.eval_steps_2d, regrasp_every=SIM.eval_regrasp_2d,
               snapshot_step=SIM.eval_regrasp_2d)
    ev_ms, eout = timed_cuda(lambda: rollout2d.rollout(*arrs16, eposes, **ekw),
                             reps=2)
    ev_plan = dict(rollout2d.LAST_PLAN)
    print(f"  K1 verify 16x384x8000: {chosen(rollout2d)}", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eref = profile_batch_ref(*arrs16, eposes, **ekw)
    torch.cuda.synchronize()
    ev_plain_ms = 1e3 * (time.perf_counter() - t0)
    # snapshot dtheta, dpos and the counters bitwise; the final pose, 7,800
    # chaotic steps later, by the bars below
    bitwise("K1 verify 16x384x8000", eout, eref, (0, 1, 2, 6, 7))
    eo = {k: v[:, :360].cpu().numpy() for k, v in zip(NAMES, eout)}
    er = {k: v[:, :360].cpu().numpy() for k, v in zip(NAMES, eref)}
    ev_stats = parity(eo, er, "eval 16x384x8000 snapshot, kernel vs plain")
    fcorr = float(np.corrcoef(eo["fth"].ravel(), er["fth"].ravel())[0, 1])
    ev_full = float(eo["cfull"][:, ::128].mean())
    ev_cheap = float(eo["ccheap"][:, ::128].mean())

    def metrics(o):
        return [profile_metrics_2d(
            o["dth"][i], np.stack([o["dpx"][i], o["dpy"][i], 0 * thetas], -1),
            o["fth"][i], thetas,
            np.stack([o["fpx"][i], o["fpy"][i], 0 * thetas], -1))
            for i in range(16)]

    t0 = time.perf_counter()
    m_out = metrics(eo)
    host_metrics_s = time.perf_counter() - t0
    agree = [float(np.mean(ma[k] == mb[k]))
             for ma, mb in zip(m_out, metrics(er))
             for k in ("profile", "profile_x", "profile_y")]
    final_err = float(np.abs(eo["fth"] - er["fth"]).max())
    print(f"  final pose after 8,000 steps: corr(final theta) {fcorr:.6f}, "
          f"max |diff| {final_err:.3g}; 3-class profile agreement min "
          f"{min(agree):.4f}; kernel {ev_ms:.1f} ms/call, plain "
          f"{ev_plain_ms:.0f} ms; full/cheap steps per block "
          f"{ev_full:.0f}/{ev_cheap:.1f} of 8,000; host per call: scene "
          f"build + upload {host_scene_s:.2f}s, metrics "
          f"{host_metrics_s:.2f}s", flush=True)
    check(fcorr >= 0.99 and min(agree) >= 0.99, "eval final/profile classes")
    ev_flops = k1_flops(contour.shape[0], arrs16[2].shape[1], ekw["steps"],
                        eout[6].cpu(), eout[7].cpu())
    ev_bound, ev_bound_by = bound_ms(
        ev_flops, k1_bytes(16, contour.shape[0], arrs16[2].shape[1], 384))

    clock.done("3")
    # ---- 4. the design loop through cli.sample.main -----------------------
    from dgdm_tpu_torch.cli import sample as sample_cli
    from dgdm_tpu_torch.eval.simeval import sim_eval_batch_2d
    from dgdm_tpu_torch.geom.fingers import denormalize_y
    from dgdm_tpu_torch.models import convert
    from dgdm_tpu_torch.models.profile2d import ProfileForward2D
    from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D

    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        unet_cfg = {"down_dims": [128, 256]}
        cls_cfg = {"width": 256, "num_trunk": 8, "object_ch": 200}
        gpath, dpath = (os.path.join(tmp, f) for f in ("unet.npz", "dyn.npz"))
        convert.save_npz(gpath, ConditionalUnet1D(**unet_cfg).state_dict(),
                         unet_cfg)
        convert.save_npz(dpath, ProfileForward2D(**cls_cfg).state_dict(),
                         cls_cfg)
        save_dir = os.path.join(tmp, "guided")
        for k in rollout2d.KERNEL_LAUNCHES:
            rollout2d.KERNEL_LAUNCHES[k] = 0
        t0 = time.perf_counter()
        report = sample_cli.main([
            "--diffusion_checkpoint_path", gpath, "--checkpoint_path", dpath,
            "--save_dir", save_dir, "--batch_size", "16",
            "--grid_size", "360", "--num_pos", "5",
            "--num_inference_steps", "5", "--num_test_objects", "2",
            "--objectives", "convergence,shift_up,rotate_clockwise",
            "--device", "cuda",
        ])
        torch.cuda.synchronize()
        design_s = time.perf_counter() - t0
        launches = dict(rollout2d.KERNEL_LAUNCHES)
        check(os.path.exists(os.path.join(save_dir, "guided_report.json")),
              "guided_report.json written")
        n_samples = 0
        for name in os.listdir(save_dir):
            if name.startswith("samples_") and name.endswith(".npy"):
                s = np.load(os.path.join(save_dir, name))
                check(s.shape == (16, 14, 1) and np.isfinite(s).all(),
                      f"{name}: finite (16, 14, 1) samples")
                n_samples += 1
        check(n_samples == 8, f"8 sample files, found {n_samples}")
        shutil.copy(os.path.join(save_dir, "guided_report.json"), OUT_DIR)
        # phase 13 renders the loop's best-success grippers
        oids, ocontours = sample_cli.load_test_objects(
            argparse.Namespace(num_test_objects=2, object_dir=""))
        render_pairs_2d = design_pairs(
            report, save_dir, dict(zip(map(str, oids), ocontours)), False)
        check(len(render_pairs_2d) == 6,
              f"6 design pairs, found {len(render_pairs_2d)}")

        # where one verification call of the loop spends its time: the
        # guided shift_up samples of the first object once more, the whole
        # call on the host clock and its K1 launch with CUDA events
        oids, ocontours = oids[:1], ocontours[:1]
        samp = np.load(os.path.join(
            save_dir, f"samples_shift_up_{oids[0]}.npy"))[..., 0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim_eval_batch_2d(samp, ocontours, device=dev)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        y = denormalize_y(samp)
        half = y.shape[1] // 2
        arrs_s = rollout2d.scene_arrays(datagen.stack_scenes(
            [engine2d.make_scene(yi[:half], yi[half:], ocontours[0])
             for yi in y]), device=dev)
        call_k_ms, sout = timed_cuda(
            lambda: rollout2d.rollout(*arrs_s, eposes, **ekw), reps=1)
        call_full = float(sout[6][:, ::128].mean())
        objectives = objective_check(gpath, dpath, save_dir, oids[0],
                                     ocontours[0], dev)
    check(launches["rollout2d"] > 0 and launches["rollout2d_jacobi"] == 0,
          f"the design path (Newton) launches K1's Newton instantiation "
          f"only: {launches}")
    print(f"design loop: {design_s:.1f}s end to end (sweep "
          f"{report['design_sweep']['seconds']:.2f}s for "
          f"{report['design_sweep']['pairs']} pairs, verification "
          f"{report['verification']['seconds']:.1f}s); kernel launches "
          f"{launches}", flush=True)
    print(f"  one verification call of the loop (shift_up samples, object "
          f"{oids[0]}): {call_s:.2f}s on the host clock, K1 "
          f"{call_k_ms:.0f} ms of it; full-solve steps per block "
          f"{call_full:.0f} of 8,000", flush=True)

    clock.done("4")
    k2 = phases_3d(dev, clock)
    render_pairs_3d = k2.pop("render_pairs")

    # ---- 8. a settled-travel step ----------------------------------------
    k1_travel = travel_step_us(rollout2d, arrs16, eposes, (14, 15), (6, 7))
    for name, tr in (("K1", k1_travel), ("K2", k2["travel"])):
        print(f"{name} settled-travel step (fingers out of reach, "
              f"G={tr['plan']['threads_per_rollout']}, clusters of "
              f"{tr['plan']['cluster']} x {tr['plan']['threads']} threads): "
              f"{tr['us_per_step']:.3f} us/step "
              f"({tr['ms'][0]:.1f} ms at {tr['depths'][0]} steps, "
              f"{tr['ms'][1]:.1f} ms at {tr['depths'][1]}; "
              f"{tr['solve_steps'][0]:.0f} solve steps in both)", flush=True)

    # earlier rows of PERF.md (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W):
    # one thread a rollout, one 128-thread block a pose group
    earlier = {"K1 verify 16x384x8000": (2744.0, ev_ms),
               "K1 datagen 8x9088x200": (177.9, dg_ms),
               "K2 verify 16x128x32000": (11448.0, k2["verify"]["kernel_ms"]),
               "K2 datagen 8x9088x800": (1300.0, k2["datagen"]["kernel_ms"])}
    for what, (old, new) in earlier.items():
        print(f"{what}: {new:.1f} ms/call now, {old:.1f} ms with one thread "
              f"a rollout (earlier row): {old / new:.2f}x", flush=True)

    clock.done("8 (with the 3D travel step)")
    # ---- 9. the data-to-checkpoint path ----------------------------------
    train = phase_train_path(dev, k2["datagen"]["kernel_ms"])
    clock.done("9")

    # ---- 10. the Jacobi configuration and gradient design -----------------
    jac = phase_jacobi_design(dev)
    clock.done("10")

    # ---- 11. the 3D Jacobi configuration, newton_tol, the pure 3D engine --
    s3 = phase_3d_solvers(dev)
    clock.done("11")

    # ---- 12. multi-GPU: entry(), two ranks on one card, NCCL --------------
    multi = phase_multi_gpu(dev, card)
    clock.done("12")

    # ---- 13. the render path: cli.sample --render_video's device part -----
    engine2d.SOLVER = "newton"
    engine3d.SOLVER3 = "newton"
    render = phase_render(dev, render_pairs_2d, render_pairs_3d)
    clock.done("13")

    # ---- summary ----------------------------------------------------------
    summary = {
        "card": card, "build_s": build_s, "registers": registers,
        "spill_bytes": {k: v[1] for k, v in ptxas.items()},
        "travel_k1": k1_travel,
        "datagen": {"kernel_ms": dg_ms, "plain_ms": dg_plain_ms,
                    "bound_ms": dg_bound, "bound_by": dg_bound_by,
                    "plan": dg_plan,
                    "rollouts_per_s": rollouts / dg_ms * 1e3,
                    "parity": dg_stats, "dtheta_bitwise_equal": dg_exact},
        "eval": {"kernel_ms": ev_ms, "plain_ms": ev_plain_ms,
                 "plan": ev_plan,
                 "parity": ev_stats, "final_theta_corr": fcorr,
                 "class_agreement_min": min(agree), "flops": ev_flops,
                 "bound_ms": ev_bound, "host_scene_s": host_scene_s,
                 "host_metrics_s": host_metrics_s,
                 "full_steps_per_block": ev_full,
                 "cheap_steps_per_block": ev_cheap},
        "design_loop_s": design_s, "launches": launches,
        "objective_check": objectives,
        "design_call": {"seconds": call_s, "kernel_ms": call_k_ms,
                        "full_steps_per_block": call_full},
        "k2": k2, "train_path": train, "jacobi": jac, "solvers_3d": s3,
        "multi_gpu": multi, "render": render, "phase_s": clock.seconds,
        "seconds": time.perf_counter() - t_start,
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    # shared bytes a block of each instantiation, at the shape of its entry
    shared = {"rollout2d": ev_plan["shared_bytes"],
              "rollout2d_jacobi": jac["datagen"]["plan"]["shared_bytes"],
              "rollout3d": k2["verify"]["plan"]["shared_bytes"],
              "rollout3d_jacobi": s3["datagen"]["plan"]["shared_bytes"],
              "rollout3d_newton_tol": s3["newton_tol"]["plan"][
                  "shared_bytes"]}
    print(json.dumps({"kernels": [{
        "name": "rollout2d", "route": "cuda",
        "source": "dgdm_tpu_torch/csrc/rollout2d.cu",
        "replaces": "dgdm_tpu/sim/pallas2d.py:76",
        "launches": launches["rollout2d"],
        "max_abs_err": max(v["max_abs_err"] for v in ev_stats.values()),
        "max_abs_err_final": final_err,
        "ms": ev_ms, "plain_ms": ev_plain_ms, "bound_ms": ev_bound,
        "bound_by": ev_bound_by, "library_ms": None,
        "shape": "16 pairs x 384 poses x 8000 steps (verification)",
        "threads_per_rollout": ev_plan["threads_per_rollout"],
        "cluster": ev_plan["cluster"],
        "registers": registers["rollout2d"],
        "spill_bytes": ptxas["rollout2d"][1],
        "shared_bytes": shared["rollout2d"],
        "datagen_ms": dg_ms, "datagen_plain_ms": dg_plain_ms,
        "datagen_bound_ms": dg_bound,
        "travel_us_per_step": k1_travel["us_per_step"],
        "datagen_cli_launches": train["dg_launches"]["rollout2d"],
        "train_path_launches": train["launches"]["rollout2d"],
        "datagen_cli_wave_ms": train["k1_wave_ms"],
        "multi_gpu_rank_launches": [r["total_launches"]["rollout2d"]
                                    for r in multi["ranks"]],
    }, {
        "name": "rollout3d", "route": "cuda",
        "source": "dgdm_tpu_torch/csrc/rollout3d.cu",
        "replaces": "dgdm_tpu/sim/pallas3d.py:91",
        "launches": k2["launches"]["rollout3d"],
        "max_abs_err": k2["max_abs_err"],
        # kernel, plain version and bound on the same work: the verification
        # shape of the 3D loop with its depth cut to 2,400 steps
        "ms": k2["short_eval"]["kernel_ms"],
        "plain_ms": k2["short_eval"]["plain_ms"],
        "bound_ms": k2["short_eval"]["bound_ms"],
        "bound_by": k2["short_eval"]["bound_by"], "library_ms": None,
        "shape": "16 pairs x 128 poses x 2400 steps (verification, depth "
                 "cut from 32000)",
        "threads_per_rollout": k2["verify"]["plan"]["threads_per_rollout"],
        "cluster": k2["verify"]["plan"]["cluster"],
        "registers": registers["rollout3d"],
        "spill_bytes": ptxas["rollout3d"][1],
        "shared_bytes": shared["rollout3d"],
        "travel_us_per_step": k2["travel"]["us_per_step"],
        "verify_ms": k2["verify"]["kernel_ms"],
        "verify_bound_ms": k2["verify"]["bound_ms"],
        "datagen_ms": k2["datagen"]["kernel_ms"],
        "datagen_plain_ms": k2["datagen"]["plain_ms"],
        "datagen_bound_ms": k2["datagen"]["bound_ms"],
        "datagen_cli_launches": train["dg_launches"]["rollout3d"],
        "train_path_launches": train["launches"]["rollout3d"],
        "multi_gpu_rank_launches": [r["total_launches"]["rollout3d"]
                                    for r in multi["ranks"]],
    }, {
        "name": "rollout2d_jacobi", "route": "cuda",
        "source": "dgdm_tpu_torch/csrc/rollout2d.cu",
        "replaces": "dgdm_tpu/sim/pallas2d.py:221",
        "launches": jac["launches"]["rollout2d_jacobi"],
        "max_abs_err": max(v["max_abs_err"]
                           for v in jac["datagen"]["parity"].values()),
        # kernel, plain version and bound on the same work: the datagen
        # shape (the plain version at the verify shape takes minutes)
        "ms": jac["datagen"]["kernel_ms"],
        "plain_ms": jac["datagen"]["plain_ms"],
        "bound_ms": jac["datagen"]["bound_ms"],
        "bound_by": jac["datagen"]["bound_by"], "library_ms": None,
        "shape": "8 pairs x 9088 poses x 200 steps (datagen)",
        "registers": registers["rollout2d_jacobi"],
        "spill_bytes": ptxas["rollout2d_jacobi"][1],
        "shared_bytes": shared["rollout2d_jacobi"],
        "verify_ms": jac["verify"]["kernel_ms"],
        "verify_bound_ms": jac["verify"]["bound_ms"],
        "verify_shape": "16 pairs x 384 poses x 8000 steps",
        "verify_plain_bitwise_steps": jac["verify"]["cut_steps"],
    }, {
        "name": "rollout3d_jacobi", "route": "cuda",
        "source": "dgdm_tpu_torch/csrc/rollout3d.cu",
        "replaces": "dgdm_tpu/sim/pallas3d.py:302",
        "launches": (s3["datagen"]["launches"]["rollout3d_jacobi"]
                     + s3["verify"]["launches"]["rollout3d_jacobi"]),
        "max_abs_err": max(v["max_abs_err"] for st in
                           s3["datagen"]["golden"].values()
                           for v in st.values()),
        # kernel, plain version and bound on the same work: the datagen
        # shape with its depth cut
        "ms": s3["datagen"]["cut"]["kernel_ms"],
        "plain_ms": s3["datagen"]["cut"]["plain_ms"],
        "bound_ms": s3["datagen"]["cut"]["bound_ms"],
        "bound_by": s3["datagen"]["cut"]["bound_by"], "library_ms": None,
        "shape": f"8 pairs x 9088 poses x {s3['datagen']['cut']['steps']} "
                 f"steps (datagen, depth cut from 800)",
        "registers": registers["rollout3d_jacobi"],
        "spill_bytes": ptxas["rollout3d_jacobi"][1],
        "shared_bytes": shared["rollout3d_jacobi"],
        "max_active_clusters": s3["datagen"]["plan"]["max_active_clusters"],
        "datagen_ms": s3["datagen"]["kernel_ms"],
        "datagen_bound_ms": s3["datagen"]["bound_ms"],
        "datagen_runs_ms": s3["datagen"]["runs_ms"],
        "verify_15_grippers_ms": s3["verify"]["kernel_ms_15"],
        "verify_ms": s3["verify"]["kernel_ms"],
        "verify_bound_ms": s3["verify"]["bound_ms"],
        "verify_plain_bitwise_steps": s3["verify"]["cut_steps"],
    }, {
        "name": "rollout3d_newton_tol", "route": "cuda",
        "source": "dgdm_tpu_torch/csrc/rollout3d.cu",
        "replaces": "dgdm_tpu/sim/pallas3d.py:714",
        "launches": s3["newton_tol"]["launches"]["rollout3d_newton_tol"],
        "max_abs_err": max(v["max_abs_err"] for st in
                           s3["newton_tol"]["golden"].values()
                           for v in st.values()),
        "ms": s3["newton_tol"]["cut"]["kernel_ms"],
        "plain_ms": s3["newton_tol"]["cut"]["plain_ms"],
        "bound_ms": s3["newton_tol"]["cut"]["bound_ms"],
        "bound_by": s3["newton_tol"]["cut"]["bound_by"], "library_ms": None,
        "shape": f"8 pairs x 9088 poses x {s3['newton_tol']['cut']['steps']} "
                 f"steps (datagen, depth cut from 800), newton_iters 6, "
                 f"newton_tol 1e-4",
        "registers": registers["rollout3d_newton_tol"],
        "spill_bytes": ptxas["rollout3d_newton_tol"][1],
        "shared_bytes": shared["rollout3d_newton_tol"],
        "datagen_ms": s3["newton_tol"]["kernel_ms"],
        "datagen_bound_ms": s3["newton_tol"]["bound_ms"],
        "fixed_count_ms": s3["newton_tol"]["fixed_kernel_ms"],
        "iters_per_full_step_mean": s3["newton_tol"][
            "iters_per_full_step_mean"],
        "iters_per_full_step_max": s3["newton_tol"]["iters_per_full_step_max"],
    }]}), flush=True)
    total_s = time.perf_counter() - t_start
    phase_s = ", ".join(f"{k.split()[0]} {v:.1f}"
                        for k, v in clock.seconds.items())
    print(f"chip_smoke total {total_s:.1f} s of {TIME_LIMIT_S:,} s "
          f"({100.0 * total_s / TIME_LIMIT_S:.1f}%; phase seconds "
          f"{phase_s})", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
