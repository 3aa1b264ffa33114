"""Closed-loop 2D design requests, one client.

A request is one (objective, object) pair of the sample CLI
(``cli/sample.py:main``) at the cell's batch: ``batch`` guided designs from
fresh DDIM noise, then their verification with re-grasp rollouts, then the
request's objectives table and best designs:

1. guidance: ``GuidedSampler2D.sweep_inputs`` + ``sample_sweep`` with the
   one pair; for 'convergence', ``generator.sample`` (the unguided
   designs), ``find_convergence_centers`` and ``sample``; the samples are
   brought to the host;
2. ``eval/simeval.sim_eval_batch_2d`` (host scene build, K1, metrics);
3. ``objectives_table`` + ``best_ids_all_metrics``.

The next request starts when the last one has finished. Requests come in
blocks of ``block``: a block holds every (objective, object) pair of a
balanced schedule (each objective as often as the others, each object as
often as the others), in an order that the run's seed draws anew for each
block. Request ``i`` of block ``b`` draws its DDIM noise on the device
from (``pool_seed``, ``b``, ``i``), so no request of a run repeats another
(the program's caches of scenes and fingers never see a design twice) and
every seed sends the same requests of each whole block, in another order.
The weights come from ``pool_seed`` too.

``compare`` judges, with the plain reference: the guided samples of
``check_requests`` requests drawn from the seed and of the slowest one
(the reference runs the whole guided DDIM again from the same noise,
weights and object); the slowest request's verification outputs (every
rollout's snapshot dtheta and dpos, final pose and its block's step
counters: the reference builds the scenes again from the program's
samples and runs the plain rollout); and that request's objectives table
and best designs, from the reference's own rollouts.
"""

from __future__ import annotations

import math
import time

import numpy as np

from perfbench import harness, weights

# the span names that name the device's idle gaps (breakdown)
GAP_SPANS = ("guidance", "verify_host", "objectives")
# the block number of the warm-up requests' noise, which no window reaches
WARM_BLOCK = 2 ** 31 - 1


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
        self.records = {"requests": [], "k1": []}
        self.attempted = 0
        self.failed = 0
        self._lines = []

    # -- set-up -----------------------------------------------------------

    def setup(self):
        import torch

        from perfbench.reference import contour as rcontour
        from perfbench.reference.config import GUIDED_OBJECTIVES, NORM
        from perfbench.reference.profile2d import ProfileForward2D as RefCls
        from perfbench.reference.unet1d import ConditionalUnet1D as RefUnet

        cfg, prm, dev = self.cfg, self.params, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.objectives = list(prm.get("objectives", GUIDED_OBJECTIVES))
        self.object_ids = list(cfg["objects"])
        # the objects: the benchmark's own copy of the icon source
        self.contours = [rcontour.extract_contours(
            rcontour.synthetic_icon(i), num_points=cfg["object_points"])
            for i in self.object_ids]
        self.obj_flats = torch.as_tensor(
            np.stack([c.reshape(-1) / NORM.object_extent_2d
                      for c in self.contours]), dtype=torch.float32,
            device=dev)
        self.threshold0 = float(NORM.threshold_std(False)[0])
        # the schedule, the requests' noise and the weights come from the
        # workload's pool seed, so that every run does the same work; the
        # run's seed draws the order (and the requests the check compares)
        pool_seed = prm["pool_seed"]
        self.unet_state = weights.seeded_state(RefUnet(**cfg["unet"]),
                                               pool_seed, dev)
        self.cls_state = weights.seeded_state(
            RefCls(**cfg["classifier"]), pool_seed + 1, dev)
        size = prm["block"]
        pool_rng = np.random.default_rng(pool_seed)
        objs = np.arange(size) % len(self.objectives)
        objects = pool_rng.permutation(np.arange(size) % len(self.object_ids))
        self.schedule = list(zip(objs.tolist(), objects.tolist()))
        self._gen = torch.Generator(device=dev)
        self.order = np.random.default_rng(self.seed)
        if self.control:
            self._setup_control()
            return
        self._setup_program()
        # warm-up: one request of each path (the fused sweep and the
        # convergence path), on the first object
        first = self.objectives.index("convergence") \
            if "convergence" in self.objectives else None
        sweep = next(i for i, o in enumerate(self.objectives)
                     if o != "convergence")
        self._request((WARM_BLOCK, 0), sweep, 0, record=False)
        if first is not None:
            self._request((WARM_BLOCK, 1), first, 0, record=False)
        self._captured.clear()

    def _setup_program(self):
        from dgdm_tpu_torch.design.guidance import GuidedSampler2D
        from dgdm_tpu_torch.eval.metrics import best_ids_all_metrics
        from dgdm_tpu_torch.eval.simeval import (
            objectives_table,
            sim_eval_batch_2d,
        )
        from dgdm_tpu_torch.models.profile2d import ProfileForward2D
        from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
        from dgdm_tpu_torch.sim import rollout2d
        from dgdm_tpu_torch.train import generator

        cfg, dev = self.cfg, self.device
        if dev.type == "cuda":
            rollout2d.LIBRARY.get()           # nvcc, or the built library
        unet = weights.load(ConditionalUnet1D(**cfg["unet"]).to(dev),
                            self.unet_state).eval()
        cls = weights.load(ProfileForward2D(**cfg["classifier"]).to(dev),
                           self.cls_state).eval()
        n_poses = cfg["grid_size"] * cfg["num_pos"] ** 2
        sampler = GuidedSampler2D(
            unet, cls, grid_size=cfg["grid_size"], num_pos=cfg["num_pos"],
            num_train_timesteps=cfg["num_train_timesteps"],
            num_inference_steps=cfg["num_inference_steps"],
            pose_chunks=max(1, -(-n_poses // cfg["sub_bs"])), device=dev)
        self._program = (unet, cls, sampler)
        self._captured = []
        real = rollout2d.rollout
        captured = self._captured

        def capture(*a, **kw):
            out = real(*a, **kw)
            captured.append(out)
            return out

        # the raw outputs of every rollout call, as the program made them
        rollout2d.rollout = capture
        self._restore = lambda: setattr(rollout2d, "rollout", real)

        def guide(objective, oi, noise):
            if objective == "convergence":
                base = generator.sample(unet, noise,
                                        cfg["num_train_timesteps"],
                                        cfg["num_inference_steps"])
                centers = sampler.find_convergence_centers(
                    base, self.obj_flats[oi], self.threshold0)
                return sampler.sample(noise, self.obj_flats[oi], objective,
                                      cfg["guidance_scale_convergence"],
                                      centers=centers)
            feats, w, rsq, sc, _ = sampler.sweep_inputs(
                [objective], self.obj_flats[oi:oi + 1], False)
            return sampler.sample_sweep(noise, feats, w, rsq, sc)[0]

        def verify(pts, oi):
            return sim_eval_batch_2d(
                pts, [self.contours[oi]], num_rot=cfg["grid_size"],
                total_steps=cfg["verify_steps"],
                regrasp_every=cfg["verify_regrasp"], device=dev)

        def table(metrics, objective):
            objs = objectives_table(metrics, objective)
            return objs, best_ids_all_metrics(objs, objective)

        self._guide, self._verify, self._table = guide, verify, table

    def _setup_control(self):
        """The reference in the program's place, one precision below the
        configuration's: TF32 in the guidance's products, float32 point
        sums in the rollouts."""
        import torch

        from perfbench.reference.point_sum import FLOAT32_SUM

        ref = self._reference()
        self._captured = []

        def guide(objective, oi, noise):
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                return ref["guided"](objective, oi, noise)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False

        def verify(pts, oi):
            raw = ref["rollout"](pts, oi, FLOAT32_SUM)
            self._captured.append(tuple(torch.as_tensor(r) for r in raw))
            return ref["metrics"](raw)

        self._guide, self._verify = guide, verify
        self._table = ref["table"]
        self._program = ()
        self._restore = lambda: None

    # -- the reference ----------------------------------------------------

    def _reference(self):
        """The plain reference's pieces, with the seeded weights."""
        import torch

        from perfbench.reference import guided, k1, metrics, scene2d
        from perfbench.reference.fingers import denormalize_y
        from perfbench.reference.profile2d import ProfileForward2D
        from perfbench.reference.unet1d import ConditionalUnet1D

        cfg, dev = self.cfg, self.device
        unet = weights.load(ConditionalUnet1D(**cfg["unet"]).to(dev),
                            self.unet_state).eval()
        cls = weights.load(ProfileForward2D(**cfg["classifier"]).to(dev),
                           self.cls_state).eval()
        for m in (unet, cls):
            m.requires_grad_(False)
        num_rot = cfg["grid_size"]
        thetas = (np.linspace(-1.0, 1.0, num_rot) * np.pi
                  + np.pi).astype(np.float32)
        th_p = scene2d.pad_poses(thetas[:, None])[:, 0]
        poses = torch.as_tensor(np.stack(
            [np.zeros_like(th_p), np.zeros_like(th_p), th_p], -1)).to(dev)

        def ref_guided(objective, oi, noise):
            scale = (cfg["guidance_scale_convergence"]
                     if objective == "convergence" else cfg["guidance_scale"])
            return guided.guided(
                unet, cls, noise, self.obj_flats[oi], objective, scale,
                cfg["grid_size"], cfg["num_pos"], cfg["num_train_timesteps"],
                cfg["num_inference_steps"], self.threshold0, cfg["sub_bs"])

        def ref_rollout(pts, oi, sum_group=0):
            y = np.asarray(denormalize_y(np.asarray(pts)))
            n = y.shape[1] // 2
            scenes = scene2d.stack_scenes([
                scene2d.make_scene(yi[:n], yi[n:], self.contours[oi])
                for yi in y])
            arrs = scene2d.scene_arrays(scenes, device=dev)
            out = k1.rollout(*arrs, poses, steps=cfg["verify_steps"],
                             regrasp_every=cfg["verify_regrasp"],
                             snapshot_step=cfg["verify_regrasp"],
                             sum_group=sum_group)
            return [o.cpu().numpy() for o in out]

        def ref_metrics(raw):
            dth, dpx, dpy, fth, fpx, fpy = (r[:, :num_rot] for r in raw[:6])
            zeros = np.zeros((num_rot, 1))
            return [metrics.profile_metrics_2d(
                dth[i], np.concatenate([np.stack([dpx[i], dpy[i]], -1),
                                        zeros], -1),
                fth[i], thetas,
                np.concatenate([np.stack([fpx[i], fpy[i]], -1), zeros], -1))
                for i in range(dth.shape[0])]

        def ref_table(mets, objective):
            objs = [metrics.metric2objective(m, objective) for m in mets]
            return objs, metrics.best_ids_all_metrics(objs, objective)

        return {"guided": ref_guided, "rollout": ref_rollout,
                "metrics": ref_metrics, "table": ref_table}

    # -- requests ---------------------------------------------------------

    def _noise(self, key):
        """The DDIM noise of request ``key`` = (block, item), drawn on the
        device from the pool seed and the key."""
        import torch

        seed = np.random.SeedSequence(
            [self.params["pool_seed"], *key]).generate_state(1)[0]
        self._gen.manual_seed(int(seed))
        return torch.randn((self.params["batch"], self.cfg["ctrlpts_dim"], 1),
                           generator=self._gen, device=self.device)

    def _request(self, key, obj_i: int, oi: int, record: bool = True):
        """Request ``key`` = (block, item), for objective ``obj_i`` and
        object ``oi``."""
        objective = self.objectives[obj_i]
        noise = self._noise(key)
        t0 = time.perf_counter()
        with self.spans.span("guidance"):
            samples = self._guide(objective, oi, noise)
            pts = samples.detach().cpu().numpy()[..., 0]
        with self.spans.span("verify_host"):
            n_before = len(self._captured)
            mets = self._verify(pts, oi)
            raw = self._captured[n_before:]
        with self.spans.span("objectives"):
            objs, best = self._table(mets, objective)
        t1 = time.perf_counter()
        if record:
            self.records["requests"].append({
                "key": key, "objective": objective, "object": oi,
                "t0": t0, "t1": t1, "samples": pts, "raw": raw,
                "objs": objs, "best": best})

    def window(self, seconds: float):
        """Requests back to back until ``seconds`` have passed, block after
        block, each in an order drawn from the run's seed; the window ends
        when the last one has finished."""
        t0 = time.perf_counter()
        block, order = -1, []
        while time.perf_counter() - t0 < seconds:
            if not order:
                block += 1
                order = self.order.permutation(len(self.schedule)).tolist()
            i = order.pop(0)
            obj_i, oi = self.schedule[i]
            self.attempted += 1
            self._request((block, i), obj_i, oi)

    def finish(self):
        """After the window: the rollouts' raw outputs to the host, the
        program's state freed."""
        import torch

        cfg = self.cfg
        for r in self.records["requests"]:
            raws = [np.stack([o.cpu().numpy() for o in raw])
                    for raw in r["raw"]]
            r["raw"] = raws[0] if len(raws) == 1 else None
            for a in raws:
                self.records["k1"].append({
                    "t_request": (r["t0"], r["t1"]),
                    "b": a.shape[1], "n": a.shape[2],
                    "p": cfg["object_points"], "s": cfg["support_points"],
                    "steps": cfg["verify_steps"],
                    "cfull": a[6], "ccheap": a[7]})
        self._restore()
        self._program = ()
        self._guide = self._verify = self._table = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- metrics ----------------------------------------------------------

    def end_to_end(self, window: harness.Window) -> dict:
        reqs = self.records["requests"]
        lat = [r["t1"] - r["t0"] for r in reqs]
        spans = {n: np.median([e - s for m, s, e in self.spans.items
                               if m == n]) for n in GAP_SPANS}
        clipped = np.mean([np.mean(np.abs(r["samples"]) >= 1.0)
                           for r in reqs])
        self._lines.append(
            f"requests {len(reqs)} in {window.seconds:.3f} s; latency "
            f"median {np.median(lat):.4f} s; span medians "
            + ", ".join(f"{n} {v:.4f} s" for n, v in spans.items())
            + f"; design values at the clip {100 * clipped:.1f}%")
        p90 = float(np.percentile(lat, 90)) if lat else math.nan
        return {"design_s": window.seconds / max(1, len(reqs)),
                "design_p90_s": p90}

    def report_lines(self):
        return self._lines

    # -- correctness ------------------------------------------------------

    def compare(self) -> dict:
        """The compared numbers (see the module's docstring)."""
        reqs = self.records["requests"]
        if not reqs:
            raise RuntimeError("no request finished in the window")
        t_ref = time.perf_counter()
        ref = self._reference()
        rng = np.random.default_rng(self.seed + 7)
        slowest = max(range(len(reqs)),
                      key=lambda k: reqs[k]["t1"] - reqs[k]["t0"])
        k = min(self.params["check_requests"], len(reqs))
        picks = sorted(set(rng.choice(len(reqs), size=k, replace=False)
                           .tolist()) | {slowest})
        gap = 0.0
        for j in picks:
            r = reqs[j]
            x = ref["guided"](r["objective"], r["object"],
                              self._noise(r["key"]))
            x = x.detach().cpu().numpy()[..., 0]
            gap = max(gap, float(np.abs(x - r["samples"]).max()))
        r = reqs[slowest]
        raw = np.stack(ref["rollout"](r["samples"], r["object"]))
        got = r["raw"]
        two_pi = 2.0 * math.pi
        dfth = np.abs(got[3] - raw[3])
        dfth = np.minimum(dfth, two_pi - dfth)
        # a rollout whose block took other solves than the reference's
        # counts as the widest angle gap
        flags = np.any(got[6:8] != raw[6:8], axis=0)
        objs, best = ref["table"](ref["metrics"](raw), r["objective"])
        table_gap = 0.0
        for a, b_ in zip(r["objs"], objs):
            for key, v in b_.items():
                va = np.asarray(a[key], np.float64)
                vb = np.asarray(v, np.float64)
                table_gap = max(table_gap, float(np.max(
                    np.abs(va - vb) / np.maximum(1.0, np.abs(vb)))))
        # another best design counts as a gap of 1
        if any(r["best"].get(key) != v for key, v in best.items()):
            table_gap = max(table_gap, 1.0)
        self._lines.append(
            f"compared: guidance of requests {picks} of {len(reqs)}; "
            f"verification and table of request {slowest} "
            f"({r['objective']}, object {self.object_ids[r['object']]}); "
            f"blocks with other step counters {int(flags.sum()) // 128}; "
            f"reference {time.perf_counter() - t_ref:.1f} s")
        return {
            "samples_gap": gap,
            "dtheta_gap_rad": float(np.where(
                flags, math.pi, np.abs(got[0] - raw[0])).max()),
            "final_theta_gap_rad": float(np.where(flags, math.pi,
                                                  dfth).max()),
            "pos_gap_m": float(max(np.abs(got[k] - raw[k]).max()
                                   for k in (1, 2, 4, 5))),
            "table_gap": table_gap,
        }
