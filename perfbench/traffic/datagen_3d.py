"""Closed-loop 3D datagen: waves back to back through
``sim/pipeline.pipeline_3d``, as ``cli/datagen3d.py`` runs one gripper
block over many objects.

A wave is one object (the configuration's meshes in turn) x the block's
grippers (``sample_gripper_3d(i)``, the indices drawn from the workload's
``pool_seed``, so that every run does the same work; the run's seed draws
their order and the mesh the waves start with) over the full pose grid
at the datagen depth. The pipeline bakes a wave's scenes on the host while
the previous wave's kernel runs, then drains and writes that wave's npz
shards (under a temporary directory of ``TMPDIR``, removed after the
run). The window feeds whole rounds of the meshes (each mesh once a
round, so that every window holds the same mix) until its time is nearly
up, and closes when the pipeline has drained its last wave.

``compare`` judges ``check_pairs`` (wave, gripper) pairs drawn from the
seed out of every wave of the window: the plain reference builds their
scenes again from the gripper indices and the meshes and runs the plain 3D
rollout; compared are each rollout's dtheta and dpos, its validity (the
tip-over give-up) and its block's step counters.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np

from perfbench import harness

GAP_SPANS = ("bake", "drain", "write")


class Traffic:
    GAP_SPANS = GAP_SPANS

    def __init__(self, cell: harness.Cell, seed: int, device,
                 control: bool = False):
        self.cfg = cell.config
        self.params = cell.params
        self.seed = seed
        self.device = device
        self.control = control
        self.spans = harness.Spans()
        self.records = {"k2": [], "summary": None}
        self.attempted = 0
        self.failed = 0
        self._lines = []
        self._captured = []
        self._restore = []

    def setup(self):
        from perfbench.reference.mesh3d import load_obj

        cfg, prm = self.cfg, self.params
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.meshes = [load_obj(os.path.join(root, f))
                       for f in cfg["object_files"]]
        # the gripper block comes from the workload's pool seed, so that
        # every run does the same work; the run's seed draws the block's
        # order, the object the waves start with and the checked pairs
        block = np.random.default_rng(prm["pool_seed"]).choice(
            prm["gripper_index_range"], size=cfg["pairs_per_wave"],
            replace=False)
        rng = np.random.default_rng(self.seed)
        self.grippers = rng.permutation(block).tolist()
        self.first_object = int(rng.integers(len(self.meshes)))
        self.tmp = tempfile.mkdtemp(prefix="perfbench_datagen_")
        if self.control:
            return
        self._setup_program()
        # warm-up: one wave of the cell's shapes (kernel built or found
        # built; the block's per-gripper host work cached as in the CLI)
        self._pipeline(self._items(1), os.path.join(self.tmp, "warm"))
        self._captured.clear()
        self.spans.items.clear()

    def _patch(self, module, name, value):
        real = getattr(module, name)
        setattr(module, name, value)
        self._restore.append((module, name, real))
        return real

    def _setup_program(self):
        from dgdm_tpu_torch.sim import datagen3d, pipeline, rollout3d

        if self.device.type == "cuda":
            rollout3d.LIBRARY.get()           # nvcc, or the built library
        captured = self._captured
        real = rollout3d.rollout

        def capture(*a, **kw):
            out = real(*a, **kw)
            captured.append(out)
            return out

        # the raw outputs of every rollout call, as the program made them;
        # the benchmark's spans around the pipeline's bake, drain and writes
        self._patch(rollout3d, "rollout", capture)
        self._patch(datagen3d, "bake_3d",
                    self.spans.wrap("bake", datagen3d.bake_3d))
        self._patch(datagen3d, "fetch_pairs_3d",
                    self.spans.wrap("drain", datagen3d.fetch_pairs_3d))
        self._patch(pipeline._Writer, "_write",
                    self.spans.wrap("write", pipeline._Writer._write))

        def run(items, save_dir):
            return pipeline.pipeline_3d(
                items, self.grippers, save_dir=save_dir,
                grid_size=self.cfg["grid_size"], num_pos=self.cfg["num_pos"],
                steps=self.cfg["datagen_steps"], device=self.device)

        self._pipeline = run

    def _items(self, waves=None, seconds=None):
        """Waves of (index, name, verts, faces): ``waves`` of them, or
        whole rounds of the meshes for about ``seconds``, so that every
        window holds each mesh equally often.

        The pipeline asks for wave k as wave k-1 starts on the card, ~(k-1)
        wave times after the first; stopping there ends the window a wave
        later. So at a round's end the feed stops where that end lies
        nearer to ``seconds`` than the next round's would, the wave time
        taken from the pace so far."""
        k = 0
        names = self.cfg["objects"]
        t0 = time.perf_counter()
        while waves is None or k < waves:
            if seconds is not None and k >= 2 and k % len(names) == 0:
                t = time.perf_counter() - t0
                if t >= seconds - 2.0 * t / (k - 1):
                    return
            j = self._object_of(k)
            yield (k, names[j]) + tuple(self.meshes[j])
            k += 1

    def _object_of(self, wave: int) -> int:
        return (self.first_object + wave) % len(self.meshes)

    def window(self, seconds: float):
        """Whole rounds of waves (one mesh each) until about ``seconds``
        have passed; the window closes when the last wave has been drained
        and written."""
        if self.control:
            self.records["summary"] = {"waves": 0, "pairs": 0,
                                       "pairs_valid": 0, "rollouts": 0,
                                       "kernel_s": 0.0, "bake_s": 0.0,
                                       "drains_under_kernel": 0}
            return
        out = self._pipeline(self._items(seconds=seconds),
                             os.path.join(self.tmp, "window"))
        self.records["summary"] = out
        self.attempted = out["pairs"]

    def finish(self):
        import torch

        cfg = self.cfg
        self.raw = []
        for out in self._captured:
            a = np.stack([o.cpu().numpy() for o in out])
            self.raw.append(a)
            self.records["k2"].append({
                "b": a.shape[1], "n": a.shape[2],
                "p": cfg["contact_points"], "steps": cfg["datagen_steps"],
                "cfull": a[9], "ccheap": a[10], "citer": a[11]})
        for module, name, real in reversed(self._restore):
            setattr(module, name, real)
        self._restore.clear()
        self._captured.clear()
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def end_to_end(self, window: harness.Window) -> dict:
        s = self.records["summary"]
        self._lines.append(
            f"waves {s['waves']} ({s['pairs']} pairs, {s['pairs_valid']} "
            f"kept) in {window.seconds:.3f} s; kernel {s['kernel_s']:.3f} s, "
            f"bake {s['bake_s']:.3f} s, drains under the next kernel "
            f"{s['drains_under_kernel']}")
        return {"datagen_rollouts_per_s": s["rollouts"] / window.seconds}

    def report_lines(self):
        return self._lines

    # -- the reference ----------------------------------------------------

    def _reference_outputs(self, pairs, sum_group=0):
        """The plain reference's 12 raw outputs of (wave, gripper-slot)
        ``pairs``: (12, len(pairs), N)."""
        import torch

        from perfbench.reference import k2, scene2d, scene3d
        from perfbench.reference.fingers import sample_gripper_3d

        cfg, dev = self.cfg, self.device
        props = {}
        scenes = []
        for wave, slot in pairs:
            j = self._object_of(wave)
            verts, faces = self.meshes[j]
            if j not in props:
                props[j] = scene3d.object_properties_3d(
                    verts, faces, num_points=cfg["contact_points"])
            yl, yr = sample_gripper_3d(self.grippers[slot])
            scenes.append(scene3d.make_scene(yl, yr, verts, faces,
                                             obj_props=props[j]))
        arrs = scene3d.scene_arrays_3d(scene2d.stack_scenes(scenes),
                                       device=dev)
        poses = torch.as_tensor(scene2d.pad_poses(scene2d.pose_grid(
            cfg["grid_size"], cfg["num_pos"]))).to(dev)
        out = k2.profile_batch_ref(*arrs, poses, steps=cfg["datagen_steps"],
                                   sum_group=sum_group,
                                   newton_iters=cfg["newton_iters"])
        return np.stack([o.cpu().numpy() for o in out]), poses.cpu()

    def _check_pairs(self, waves: int):
        rng = np.random.default_rng(self.seed + 7)
        every = [(w, s) for w in range(waves)
                 for s in range(self.cfg["pairs_per_wave"])]
        k = min(self.params["check_pairs"], len(every))
        return [every[i] for i in sorted(rng.choice(len(every), size=k,
                                                    replace=False))]

    def compare(self) -> dict:
        import torch

        from perfbench.reference import k2
        from perfbench.reference.point_sum import FLOAT32_SUM

        t_ref = time.perf_counter()
        if self.control:
            # the reference in the program's place, its point sums in
            # float32: one wave's compared pairs
            pairs = self._check_pairs(1)
            got, _ = self._reference_outputs(pairs, FLOAT32_SUM)
        else:
            pairs = self._check_pairs(len(self.raw))
            got = np.stack([self.raw[w][:, s] for w, s in pairs], axis=1)
        ref, poses = self._reference_outputs(pairs)

        def view(a):
            t = [torch.as_tensor(x) for x in a[:9]]
            dth, sdpos, _, valid, _ = k2.readout(*t, poses)
            return dth.numpy(), sdpos.numpy(), valid.numpy()

        g_dth, g_dpos, g_valid = view(got)
        r_dth, r_dpos, r_valid = view(ref)
        dth = np.abs(g_dth - r_dth)
        dth = np.minimum(dth, 2.0 * math.pi - dth)
        # a rollout whose validity, or whose block's step counters, differ
        # from the reference's counts as the widest angle gap
        flags = np.any(got[9:12] != ref[9:12], axis=0) | (g_valid != r_valid)
        self._lines.append(
            f"compared pairs (wave, gripper slot): {pairs}; rollouts with "
            f"another validity or step counters {int(flags.sum())}; "
            f"reference {time.perf_counter() - t_ref:.1f} s")
        return {
            "dtheta_gap_rad": float(np.where(flags, math.pi, dth).max()),
            "dpos_gap_m": float(np.abs(g_dpos - r_dpos).max()),
        }
