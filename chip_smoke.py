"""Drive the PyTorch port (dgdm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (``nvidia-smi`` name and power limit); build every hand-written
   kernel from the sources in this checkout (one ``nvcc`` per source, all
   started together) and report the build time;
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
   of the first object) then runs once more, timed whole and K1 alone;
5. times: kernel and plain version per call, rollouts/s, design sweep.

It then prints a ``{"kernels": [...]}`` line and, as its last line,
``{"ok": true, "device": {...}}``. It exits non-zero, without that line, if
CUDA is missing, a kernel does not build, launch or agree, or a phase fails.
Bars (as in tests/test_torch_rollout2d.py): >= 99% of lanes within 1e-3 and
corr >= 0.999 for dtheta and dpos; step counters equal per 128-pose block.
"""

from __future__ import annotations

import argparse
import json
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
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


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
    for k in ("cfull", "ccheap"):
        if k in ref:
            check(np.array_equal(np.asarray(out[k])[:, ::lane],
                                 np.asarray(ref[k])[:, ::lane]),
                  f"{what}: {k} counters differ")
    print(f"  {what}: " + ", ".join(
        f"{k} {v['frac_1e-3']:.5f} within 1e-3, corr {v['corr']:.6f}, "
        f"max err {v['max_abs_err']:.3g}" for k, v in stats.items()),
        flush=True)
    return stats


def timed_cuda(fn, reps: int):
    """Mean ms per call over ``reps`` calls, with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


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
    return 4 * (b * (2 * 6 * 4 + 2 * p + 4 * s + 16) + 3 * n + 8 * b * n)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    from dgdm_tpu_torch.sim import datagen, engine2d, rollout2d
    from dgdm_tpu_torch.sim.rollout2d_ref import profile_batch_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT_DIR, exist_ok=True)
    t_start = time.perf_counter()

    # ---- 1. the card and the build --------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not readable"
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libraries = {"rollout2d": rollout2d.LIBRARY}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        builds = {k: pool.submit(lib.build) for k, lib in libraries.items()}
        for k, fut in builds.items():
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"build: {len(libraries)} kernel source(s) in {build_s:.1f}s",
          flush=True)
    for k, lib in libraries.items():
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {k}: {line.strip()}", flush=True)
    for lib in libraries.values():
        lib.get()

    # ---- 2. K1 datagen schedule at full size ------------------------------
    contour = extract_contours(synthetic_icon(0))
    scenes8 = datagen.stack_scenes(
        [engine2d.make_scene(*sample_gripper_2d(i), contour) for i in range(8)])
    arrs8 = rollout2d.scene_arrays(scenes8, device=dev)
    poses = torch.as_tensor(datagen.pad_poses(engine2d.pose_grid()),
                            device=dev)
    check(poses.shape == (9088, 3), "padded datagen grid")
    dg_ms, out = timed_cuda(lambda: rollout2d.rollout(*arrs8, poses), reps=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = profile_batch_ref(*arrs8, poses)
    torch.cuda.synchronize()
    dg_plain_ms = 1e3 * (time.perf_counter() - t0)
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
          f"{out_np['ccheap'][:, ::128].mean():.2f}", flush=True)

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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eref = profile_batch_ref(*arrs16, eposes, **ekw)
    torch.cuda.synchronize()
    ev_plain_ms = 1e3 * (time.perf_counter() - t0)
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

        # where one verification call of the loop spends its time: the
        # guided shift_up samples of the first object once more, the whole
        # call on the host clock and its K1 launch with CUDA events
        oids, ocontours = sample_cli.load_test_objects(
            argparse.Namespace(num_test_objects=1, object_dir=""))
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
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the design path")
    print(f"design loop: {design_s:.1f}s end to end (sweep "
          f"{report['design_sweep']['seconds']:.2f}s for "
          f"{report['design_sweep']['pairs']} pairs, verification "
          f"{report['verification']['seconds']:.1f}s); kernel launches "
          f"{launches}", flush=True)
    print(f"  one verification call of the loop (shift_up samples, object "
          f"{oids[0]}): {call_s:.2f}s on the host clock, K1 "
          f"{call_k_ms:.0f} ms of it; full-solve steps per block "
          f"{call_full:.0f} of 8,000", flush=True)

    # ---- 5. summary -------------------------------------------------------
    summary = {
        "card": card, "build_s": build_s,
        "datagen": {"kernel_ms": dg_ms, "plain_ms": dg_plain_ms,
                    "rollouts_per_s": rollouts / dg_ms * 1e3,
                    "parity": dg_stats, "dtheta_bitwise_equal": dg_exact},
        "eval": {"kernel_ms": ev_ms, "plain_ms": ev_plain_ms,
                 "parity": ev_stats, "final_theta_corr": fcorr,
                 "class_agreement_min": min(agree), "flops": ev_flops,
                 "bound_ms": ev_bound, "host_scene_s": host_scene_s,
                 "host_metrics_s": host_metrics_s,
                 "full_steps_per_block": ev_full,
                 "cheap_steps_per_block": ev_cheap},
        "design_loop_s": design_s, "launches": launches,
        "design_call": {"seconds": call_s, "kernel_ms": call_k_ms,
                        "full_steps_per_block": call_full},
        "seconds": time.perf_counter() - t_start,
    }
    with open(os.path.join(OUT_DIR, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
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
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
