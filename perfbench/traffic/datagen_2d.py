"""Closed-loop 2D datagen: waves back to back through
``sim/pipeline.pipeline_2d``, as ``cli/datagen.py`` runs one gripper block
over many objects.

A wave is one object x the block's grippers (``sample_gripper_2d(i)``, the
``pairs_per_wave`` indices drawn from the workload's ``pool_seed`` out of
the configuration's ``num_grippers``, so that every run does the same
work; the run's seed draws their order and the object the waves start
with) over the full pose grid at the datagen depth, the program's own
``SIM.steps_2d`` (the configuration's ``datagen_steps`` must equal it).
The objects are ``synthetic_icon(i)`` for the CLI's ``--object_start``
and the configuration's ``num_objects`` (the benchmark's own copy of the
icon source and contour extraction; Icons-50 is not in the repository).
The pipeline bakes a wave's scenes on the host while the previous wave's
kernel runs, then drains and writes that wave's npz shards (under a
temporary directory of ``TMPDIR``, named by wave so that no shard
overwrites another, removed after the run). The window feeds whole rounds
of the objects (each once a round, so that every window holds the same
mix) until its time is nearly up, and closes when the pipeline has drained
its last wave.

``compare`` judges ``check_pairs`` (wave, gripper) pairs drawn from the
seed out of every wave of the window. They are drawn as the waves drain (a
reservoir sample), so that the run keeps a few MB of the rollouts' raw
outputs, not ~10 MB a wave: of each drained wave the block step counters
(for the per-layer metrics), and of the drawn pairs their lanes' step
counters. For each pair the record is its shard as written
(``delta_theta``, ``delta_pos``);
the plain reference builds the scene again from the gripper index and the
icon and runs the plain K1 (``reference/k1.py``, CUDA-graph replay on the
card); compared are the rollouts' dtheta and dpos, and the block step
counters, where any difference counts as the widest angle gap.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np

from perfbench import harness, program_spans
from perfbench.reference.scene2d import LANE

GAP_SPANS = ("bake", "drain", "write")
# the program's spans whose counts each run reports, per wave
COUNTED_SPANS = ("datagen.arrays", "datagen.records", "scene.object",
                 "scene.jaw_mass.native", "scene.jaw_mass.python")


class _Reservoir:
    """A uniform draw of ``size`` items out of a stream of unknown length
    (Algorithm R), from ``rng``: ``offer`` says which kept item, if any,
    the new one replaces."""

    def __init__(self, size: int, rng):
        self.size = size
        self.rng = rng
        self.seen = 0
        self.items = []

    def offer(self, item):
        """-> (kept, dropped): whether ``item`` was kept, and the item it
        replaced (None where none)."""
        t = self.seen
        self.seen += 1
        if t < self.size:
            self.items.append(item)
            return True, None
        j = int(self.rng.integers(t + 1))
        if j >= self.size:
            return False, None
        dropped, self.items[j] = self.items[j], item
        return True, dropped


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
        self.records = {"k1": [], "summary": None}
        self.attempted = 0
        self.failed = 0
        self._lines = []
        self._raw = []
        self._restore = []
        self._window = None

    # -- set-up -----------------------------------------------------------

    def setup(self):
        from dgdm_tpu_torch.core.config import SIM
        from perfbench.reference import contour as rcontour

        cfg, prm = self.cfg, self.params
        if cfg["datagen_steps"] != SIM.steps_2d:
            raise ValueError(
                f"datagen_steps {cfg['datagen_steps']}: pipeline_2d runs "
                f"{SIM.steps_2d} steps a rollout")
        first = prm["object_start"]
        self.contours = [rcontour.extract_contours(
            rcontour.synthetic_icon(i), num_points=cfg["object_points"])
            for i in range(first, first + cfg["num_objects"])]
        block = np.random.default_rng(prm["pool_seed"]).choice(
            cfg["num_grippers"], size=prm["pairs_per_wave"],
            replace=False)
        rng = np.random.default_rng(self.seed)
        self.grippers = rng.permutation(block).tolist()
        self.first_object = int(rng.integers(len(self.contours)))
        self.tmp = tempfile.mkdtemp(prefix="perfbench_datagen2d_")
        if self.control:
            return
        self._setup_program()
        # warm-up: one wave of the cell's shapes (kernel built or found
        # built; the block's fingers cached, as in a CLI run over many
        # objects)
        self._start_keeping()
        self._pipeline(self._items(1), os.path.join(self.tmp, "warm"))
        self.spans.items.clear()

    def _patch(self, module, name, value):
        real = getattr(module, name)
        setattr(module, name, value)
        self._restore.append((module, name, real))
        return real

    def _setup_program(self):
        from dgdm_tpu_torch.sim import pipeline, rollout2d

        if self.device.type == "cuda":
            rollout2d.LIBRARY.get()           # nvcc, or the built library
        raw = self._raw
        real = rollout2d.rollout

        def capture(coefs, contour, support, *a, **kw):
            out = real(coefs, contour, support, *a, **kw)
            raw.append((contour.shape[1], support.shape[1], out))
            return out

        real_waves = pipeline._run_waves
        spans = self.spans

        def run_waves(items, bake, launch, drain, *rest):
            return real_waves(items, spans.wrap("bake", bake), launch,
                              spans.wrap("drain", drain), *rest)

        # the raw outputs of every rollout call, as the program made them;
        # the benchmark's spans around the pipeline's bakes, drains and
        # writes
        self._patch(rollout2d, "rollout", capture)
        self._patch(pipeline, "_run_waves", run_waves)
        self._patch(pipeline._Writer, "_write",
                    spans.wrap("write", pipeline._Writer._write))

        def run(items, save_dir):
            self._save_dir = save_dir
            return pipeline.pipeline_2d(
                items, self.grippers, save_dir=save_dir,
                grid_size=self.cfg["grid_size"], num_pos=self.cfg["num_pos"],
                device=self.device)

        self._pipeline = run

    # -- what the check keeps of each wave -------------------------------

    def _start_keeping(self):
        self._raw.clear()
        self._kept_waves = 0
        self._counters = []
        self._picks = {}
        self._reservoir = _Reservoir(self.params["check_pairs"],
                                     np.random.default_rng(self.seed + 7))

    def _keep(self, drained: int):
        """Keep what the check and the metrics need of waves
        [kept, drained), whose drains have waited for their kernels, and
        let go of their raw outputs. The copies are queued on the stream
        behind the next wave's kernel; nothing here waits for the card."""
        import torch

        for w in range(self._kept_waves, drained):
            p, s, out = self._raw[w]                  # 8 planes (B, N)
            b, n = out[0].shape
            self._counters.append((p, s, n, torch.stack(
                [out[6][:, ::LANE], out[7][:, ::LANE]])))
            for slot in range(b):
                kept, dropped = self._reservoir.offer((w, slot))
                if dropped is not None:
                    del self._picks[dropped]
                if kept:
                    self._picks[(w, slot)] = torch.stack(
                        [out[6][slot], out[7][slot]])
            self._raw[w] = None
        self._kept_waves = max(self._kept_waves, drained)

    def _items(self, waves=None, seconds=None):
        """Waves of (index, contour): ``waves`` of them, or whole rounds of
        the objects for about ``seconds``, so that every window holds each
        object equally often. The index is the wave's number, which names
        its shards.

        The pipeline asks for wave k as wave k-1 starts on the card, ~(k-1)
        wave times after the first; stopping there ends the window a wave
        later. So at a round's end the feed stops where that end lies
        nearer to ``seconds`` than the next round's would, the wave time
        taken from the pace so far. When wave k is asked for, waves up to
        k-2 have been drained: what the check needs of them is kept
        then, outside the pipeline's own spans."""
        k = 0
        n = len(self.contours)
        t0 = time.perf_counter()
        while waves is None or k < waves:
            self._keep(max(0, k - 1))
            if seconds is not None and k >= 2 and k % n == 0:
                t = time.perf_counter() - t0
                if t >= seconds - 2.0 * t / (k - 1):
                    return
            yield k, self.contours[self._object_of(k)]
            k += 1

    def _object_of(self, wave: int) -> int:
        return (self.first_object + wave) % len(self.contours)

    # -- the window -------------------------------------------------------

    def window(self, seconds: float):
        """Whole rounds of waves (one icon each) until about ``seconds``
        have passed; the window closes when the last wave has been drained
        and written."""
        if self.control:
            self.records["summary"] = {"waves": 0, "pairs": 0, "rollouts": 0}
            return
        self._start_keeping()
        t0 = time.perf_counter()
        out = self._pipeline(self._items(seconds=seconds),
                             os.path.join(self.tmp, "window"))
        self._window = (t0, time.perf_counter())
        self.records["summary"] = out
        self.attempted = out["pairs"]

    def finish(self):
        import torch

        from dgdm_tpu_torch.sim import datagen

        cfg = self.cfg
        self.checked = {}
        if not self.control:
            self._keep(len(self._raw))
            steps = cfg["datagen_steps"]
            for p, s, n, c in self._counters:
                a = c.cpu().numpy()
                self.records["k1"].append({
                    "b": a.shape[1], "n": n, "p": p, "s": s, "steps": steps,
                    "lanes_per_block": LANE, "cfull": a[0], "ccheap": a[1]})
            for (w, slot), counters in sorted(self._picks.items()):
                path = datagen.shard_path(self._save_dir, w,
                                          self.grippers[slot])
                rec = None
                if os.path.exists(path):
                    rec = np.load(path, allow_pickle=True)["arr_0"].item()
                self.checked[(w, slot)] = (counters.cpu().numpy(), rec)
        self._counters, self._picks = [], {}
        self._raw.clear()
        for module, name, real in reversed(self._restore):
            setattr(module, name, real)
        self._restore.clear()
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- metrics ----------------------------------------------------------

    def end_to_end(self, window: harness.Window) -> dict:
        s = self.records["summary"]
        return {"datagen_rollouts_per_s": s["rollouts"] / window.seconds}

    def report_lines(self):
        s = self.records["summary"]
        if s is None or self.control:
            return self._lines
        waves = max(1, s["waves"])
        lines = [
            f"waves {s['waves']} ({s['pairs']} pairs); kernel "
            f"{s['kernel_s']:.3f} s, bake {s['bake_s']:.3f} s, drains "
            f"{s['wait_s']:.3f} s, writes {s['write_s']:.3f} s; drains "
            f"under the next kernel {s['drains_under_kernel']}"]
        if self._window is not None:
            t0, t1 = self._window
            spans = program_spans.in_window(
                harness.Window(t0, t1, None, {}, {}))
            counts = {n: sum(m == n for m, _, _ in spans)
                      for n in COUNTED_SPANS}
            ms = {n: 1e3 * sum(e - b for m, b, e in spans if m == n)
                  for n in COUNTED_SPANS}
            if spans:
                lines.append("program spans a wave: " + ", ".join(
                    f"{n} {c / waves:g}" for n, c in counts.items()))
                lines.append("program span ms a wave: " + ", ".join(
                    f"{n} {t / waves:.3f}" for n, t in ms.items()))
            else:
                lines.append("program spans: none recorded (untraced run)")
        return lines + self._lines

    # -- the reference ----------------------------------------------------

    def _poses(self):
        from perfbench.reference import scene2d

        return scene2d.pad_poses(scene2d.pose_grid(self.cfg["grid_size"],
                                                   self.cfg["num_pos"]))

    def _reference_outputs(self, pairs, sum_group=0):
        """The plain reference's 8 raw outputs of (wave, gripper-slot)
        ``pairs``: (8, len(pairs), N)."""
        import torch

        from perfbench.reference import k1, scene2d
        from perfbench.reference.fingers import sample_gripper_2d

        scenes = [scene2d.make_scene(*sample_gripper_2d(self.grippers[slot]),
                                     self.contours[self._object_of(wave)])
                  for wave, slot in pairs]
        arrs = scene2d.scene_arrays(scene2d.stack_scenes(scenes),
                                    device=self.device)
        poses = torch.as_tensor(self._poses()).to(self.device)
        out = k1.rollout(*arrs, poses, steps=self.cfg["datagen_steps"],
                         sum_group=sum_group)
        return np.stack([o.cpu().numpy() for o in out])

    def _control_pairs(self):
        """The pairs of one wave that the seed's draw keeps."""
        res = _Reservoir(self.params["check_pairs"],
                         np.random.default_rng(self.seed + 7))
        for slot in range(len(self.grippers)):
            res.offer((0, slot))
        return sorted(res.items)

    def compare(self) -> dict:
        from perfbench.reference.point_sum import FLOAT32_SUM

        t_ref = time.perf_counter()
        n = self.cfg["grid_size"] * self.cfg["num_pos"] ** 2
        if self.control:
            # the reference in the program's place, its point sums in
            # float32: one wave's compared pairs
            pairs = self._control_pairs()
            got = self._reference_outputs(pairs, FLOAT32_SUM)
            vals, counters = got[0:3, :, :n], got[6:8, :, :n]
            missing = np.zeros(len(pairs), bool)
        else:
            pairs = sorted(self.checked)
            if not pairs:
                raise RuntimeError("no wave drained in the window")
            counters = np.stack([self.checked[p][0] for p in pairs],
                                axis=1)[:, :, :n]
            recs = [self.checked[p][1] for p in pairs]
            missing = np.array([r is None for r in recs])
            # dtheta, dpos x and y as written; a missing shard reads 0
            vals = np.zeros((3, len(pairs), n), np.float32)
            for i, r in enumerate(recs):
                if r is not None:
                    vals[:, i] = (r["delta_theta"], r["delta_pos"][:, 0],
                                  r["delta_pos"][:, 1])
        ref = self._reference_outputs(pairs)
        # a rollout whose block's step counters differ from the
        # reference's, or whose shard is missing, counts as the widest
        # angle gap
        flags = (np.any(counters != ref[6:8, :, :n], axis=0)
                 | missing[:, None])
        gap = np.abs(vals - ref[0:3, :, :n])
        self._lines.append(
            f"compared pairs (wave, gripper slot): {pairs}; rollouts with "
            f"other step counters or no shard {int(flags.sum())}; shards "
            f"missing {int(missing.sum())}; reference "
            f"{time.perf_counter() - t_ref:.1f} s")
        return {
            "dtheta_gap_rad": float(np.where(flags, math.pi, gap[0]).max()),
            "dpos_gap_m": float(gap[1:].max()),
        }

