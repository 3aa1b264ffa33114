"""Closed-loop 3D design requests, one client.

A request is one (objective, object) pair of the sample CLI with
``--fingers_3d`` (``cli/sample.py:main``) at the cell's batch: ``batch``
guided designs of 42 control values from fresh DDIM noise, steered by the
3D classifier (PointNet++ over the object's 512-point cloud) over the
45 x 5 x 5 pose grid, then their verification with re-grasp rollouts, then
the request's objectives table and best designs:

1. guidance: ``GuidedSampler.sweep_inputs(..., fingers_3d=True)`` +
   ``sample_sweep`` with the one pair; for 'convergence',
   ``generator.sample`` (the unguided designs),
   ``find_convergence_centers`` and ``sample``; the samples are brought to
   the host;
2. ``eval/simeval3d.sim_eval_batch_3d`` with the CLI's ``num_rot =
   grid_size`` orientations (padded to 128): the object's contact points,
   the host scene build (per jaw a hull mass and a surface fit), K2 over
   the verification depth with a re-grasp every 800 steps, the metrics;
3. ``objectives_table`` + ``best_ids_all_metrics``.

The next request starts when the last one has finished. Requests come in
blocks of 2 x 12: each objective once per mesh. Within a block the meshes
alternate, the first mesh first, and each mesh's objectives come in an
order that the run's seed draws anew for each block, so any window holds
both meshes about equally. Request ``(b, i)`` (block ``b``, ``i`` = mesh x
12 + objective) draws its DDIM noise on the device from (``pool_seed``,
``b``, ``i``), so no request of a run repeats another (the program's finger
and fit caches never see a design twice) and every seed sends the same
requests of each whole block, in another order. The weights come from
``pool_seed`` too.

``compare`` judges, with the plain reference: the guided samples of
``check_requests`` requests drawn from the seed and of the slowest one
(the reference runs the whole guided DDIM again from the same noise,
weights and object cloud); the slowest request's verification outputs for
all its designs (every rollout's snapshot dtheta and dpos, final pose,
validity and its block's step counters: the reference builds the scenes
again from the program's samples and runs the plain rollout at the full
depth, ``reference/k2_graph.py``); and that request's objectives table and
best designs, from the reference's own rollouts.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np

from perfbench import harness, weights

# the span names that name the device's idle gaps (breakdown)
GAP_SPANS = ("guidance", "verify_host", "objectives")
# the block number of the warm-up requests' noise, which no window reaches
WARM_BLOCK = 2 ** 31 - 1
# K2's 12 raw output planes: the snapshot's and the final pose's, validity,
# the step counters (reference/k2.py OUT_NAMES)
COUNTERS = slice(9, 12)


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
        self.records = {"requests": [], "k2": []}
        self.attempted = 0
        self.failed = 0
        self._lines = []

    # -- set-up -----------------------------------------------------------

    def setup(self):
        import torch

        from perfbench.reference import mesh3d, scene3d
        from perfbench.reference.config import GUIDED_OBJECTIVES, NORM
        from perfbench.reference.profile3d import ProfileForward3D as RefCls
        from perfbench.reference.unet1d import ConditionalUnet1D as RefUnet

        cfg, prm, dev = self.cfg, self.params, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.objectives = list(prm.get("objectives", GUIDED_OBJECTIVES))
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.meshes = [mesh3d.load_obj(os.path.join(root, f))
                       for f in cfg["object_files"]]
        # the object clouds as the CLI makes them (load_test_objects_3d),
        # from the benchmark's copy of the sampler
        clouds = []
        e = NORM.object_extent_3d_xy
        z0, z1 = NORM.object_z_min_3d, NORM.object_z_max_3d
        for verts, faces in self.meshes:
            pts = np.array(mesh3d.sample_surface(verts, faces,
                                                 cfg["cloud_points"]))
            pts[:, 0] = (pts[:, 0] + e) / (2 * e) * 2 - 1
            pts[:, 1] = (pts[:, 1] + e) / (2 * e) * 2 - 1
            pts[:, 2] = (pts[:, 2] - z0) / (z1 - z0) * 2 - 1
            clouds.append(pts.astype(np.float32))
        self.obj_flats = torch.as_tensor(np.stack(clouds), device=dev)
        self.obj_props = [scene3d.object_properties_3d(
            v, f, num_points=cfg["contact_points"]) for v, f in self.meshes]
        self.threshold0 = float(NORM.threshold_std(True)[0])
        pool_seed = prm["pool_seed"]
        self.unet_state = weights.seeded_state(RefUnet(**cfg["unet"]),
                                               pool_seed, dev)
        self.cls_state = weights.seeded_state(
            RefCls(**cfg["classifier"]), pool_seed + 1, dev)
        self._gen = torch.Generator(device=dev)
        self.order = np.random.default_rng(self.seed)
        if self.control:
            self._setup_control()
            return
        self._setup_program()
        # warm-up: one request of each path (the fused sweep and the
        # convergence path) on the first mesh
        n_obj = len(self.objectives)
        sweep = next(i for i, o in enumerate(self.objectives)
                     if o != "convergence")
        self._request((WARM_BLOCK, sweep), sweep, 0, record=False)
        if "convergence" in self.objectives:
            conv = self.objectives.index("convergence")
            self._request((WARM_BLOCK, n_obj + conv), conv, 0, record=False)
        self._captured.clear()

    def _setup_program(self):
        from dgdm_tpu_torch.design.guidance import GuidedSampler
        from dgdm_tpu_torch.eval.metrics import best_ids_all_metrics
        from dgdm_tpu_torch.eval.simeval import objectives_table
        from dgdm_tpu_torch.eval.simeval3d import sim_eval_batch_3d
        from dgdm_tpu_torch.models.profile3d import ProfileForward3D
        from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
        from dgdm_tpu_torch.sim import rollout3d
        from dgdm_tpu_torch.train import generator

        cfg, dev = self.cfg, self.device
        if dev.type == "cuda":
            rollout3d.LIBRARY.get()           # nvcc, or the built library
        unet = weights.load(ConditionalUnet1D(**cfg["unet"]).to(dev),
                            self.unet_state).eval()
        cls = weights.load(ProfileForward3D(**cfg["classifier"]).to(dev),
                           self.cls_state).eval()
        n_poses = cfg["grid_size"] * cfg["num_pos"] ** 2
        sampler = GuidedSampler(
            unet, cls, grid_size=cfg["grid_size"], num_pos=cfg["num_pos"],
            num_train_timesteps=cfg["num_train_timesteps"],
            num_inference_steps=cfg["num_inference_steps"],
            pose_chunks=max(1, -(-n_poses // cfg["sub_bs"])), device=dev)
        self._program = (unet, cls, sampler)
        self._captured = []
        real = rollout3d.rollout
        captured = self._captured

        def capture(*a, **kw):
            out = real(*a, **kw)
            captured.append(out)
            return out

        # the raw outputs of every rollout call, as the program made them
        rollout3d.rollout = capture
        self._restore = lambda: setattr(rollout3d, "rollout", real)

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
                [objective], self.obj_flats[oi:oi + 1], True)
            return sampler.sample_sweep(noise, feats, w, rsq, sc)[0]

        def verify(pts, oi):
            return sim_eval_batch_3d(
                pts, [self.meshes[oi]], num_rot=cfg["verify_orientations"],
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

    def _poses(self):
        """The verification's orientations (radians) and its (N, 3) poses,
        padded to whole 128-lane blocks with the last (as
        ``sim_eval_batch_3d`` makes them)."""
        from perfbench.reference import scene2d

        num_rot = self.cfg["verify_orientations"]
        thetas = (np.linspace(-1.0, 1.0, num_rot) * np.pi
                  + np.pi).astype(np.float32)
        th_p = scene2d.pad_poses(thetas[:, None])[:, 0]
        return thetas, np.stack([np.zeros_like(th_p), np.zeros_like(th_p),
                                 th_p], -1)

    def _reference(self):
        """The plain reference's pieces, with the seeded weights."""
        import torch

        from perfbench.reference import guided, k2, k2_graph, metrics
        from perfbench.reference import scene2d, scene3d
        from perfbench.reference.config import NORM
        from perfbench.reference.fingers import denormalize_y
        from perfbench.reference.profile3d import ProfileForward3D
        from perfbench.reference.unet1d import ConditionalUnet1D

        cfg, dev = self.cfg, self.device
        unet = weights.load(ConditionalUnet1D(**cfg["unet"]).to(dev),
                            self.unet_state).eval()
        cls = weights.load(ProfileForward3D(**cfg["classifier"]).to(dev),
                           self.cls_state).eval()
        for m in (unet, cls):
            m.requires_grad_(False)
        num_rot = cfg["verify_orientations"]
        thetas, poses_np = self._poses()
        poses = torch.as_tensor(poses_np).to(dev)
        th3 = NORM.threshold_3d

        def ref_guided(objective, oi, noise):
            scale = (cfg["guidance_scale_convergence"]
                     if objective == "convergence" else cfg["guidance_scale"])
            return guided.guided(
                unet, cls, noise, self.obj_flats[oi], objective, scale,
                cfg["grid_size"], cfg["num_pos"], cfg["num_train_timesteps"],
                cfg["num_inference_steps"], self.threshold0, cfg["sub_bs"])

        def ref_rollout(pts, oi, sum_group=0):
            y = np.asarray(denormalize_y(np.asarray(pts), fingers_3d=True))
            n = y.shape[1] // 2
            verts, faces = self.meshes[oi]
            scenes = scene2d.stack_scenes([
                scene3d.make_scene(yi[:n], yi[n:], verts, faces,
                                   obj_props=self.obj_props[oi])
                for yi in y])
            arrs = scene3d.scene_arrays_3d(scenes, device=dev)
            out = k2_graph.rollout(
                *arrs, poses, steps=cfg["verify_steps"],
                regrasp_every=cfg["verify_regrasp"],
                snapshot_step=cfg["verify_regrasp"], sum_group=sum_group,
                newton_iters=cfg["newton_iters"])
            return [o.cpu().numpy() for o in out]

        def ref_metrics(raw):
            # the readout on the program's device, as profile_batch reads
            t = [torch.as_tensor(x).to(dev) for x in raw[:9]]
            dth, sdpos, fth, _, fdpos = (
                x[:, :num_rot].cpu().numpy()
                for x in k2.readout(*t, poses))
            out = []
            for i in range(dth.shape[0]):
                fdt = np.asarray([metrics.wrap_pi(f - t0)
                                  for f, t0 in zip(fth[i], thetas)])
                zeros = np.zeros((num_rot, 1))
                out.append({
                    "delta_theta": dth[i] * 180 / np.pi,
                    "delta_pos": np.concatenate([sdpos[i], zeros], -1) * 100,
                    "profile": metrics.three_class(dth[i], th3[0]),
                    "profile_x": metrics.three_class(sdpos[i][:, 0], th3[1]),
                    "profile_y": metrics.three_class(sdpos[i][:, 1], th3[2]),
                    "final_theta": fth[i] * 180 / np.pi,
                    "final_delta_theta": fdt * 180 / np.pi,
                    "final_pos": np.concatenate([fdpos[i], zeros], -1) * 100,
                })
            return out

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
        mesh ``oi``."""
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

    def _block(self):
        """One block's requests in the order sent: (item, objective, mesh),
        the meshes alternating, each mesh's objectives in a fresh order."""
        n_obj, n_mesh = len(self.objectives), len(self.meshes)
        orders = [self.order.permutation(n_obj).tolist()
                  for _ in range(n_mesh)]
        return [(m * n_obj + orders[m][j], orders[m][j], m)
                for j in range(n_obj) for m in range(n_mesh)]

    def window(self, seconds: float):
        """Requests back to back until ``seconds`` have passed, block after
        block; the window ends when the last one has finished."""
        t0 = time.perf_counter()
        block, order = -1, []
        while time.perf_counter() - t0 < seconds:
            if not order:
                block += 1
                order = self._block()
            item, obj_i, oi = order.pop(0)
            self.attempted += 1
            self._request((block, item), obj_i, oi)

    def finish(self):
        """After the window: the rollouts' raw outputs to the host, the
        program's state freed."""
        import torch

        cfg = self.cfg
        for r in self.records["requests"]:
            raws = [np.stack([np.asarray(o.cpu()) for o in raw])
                    for raw in r["raw"]]
            r["raw"] = raws[0] if len(raws) == 1 else None
            for a in raws:
                self.records["k2"].append({
                    "t_request": (r["t0"], r["t1"]),
                    "b": a.shape[1], "n": a.shape[2],
                    "p": cfg["contact_points"], "steps": cfg["verify_steps"],
                    "cfull": a[9], "ccheap": a[10], "citer": a[11]})
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
        meshes = [sum(r["object"] == m for r in reqs)
                  for m in range(len(self.meshes))]
        self._lines.append(
            f"requests {len(reqs)} in {window.seconds:.3f} s (by mesh "
            f"{meshes}); latency median {np.median(lat):.4f} s, p90 "
            f"{np.percentile(lat, 90):.4f} s, max {np.max(lat):.4f} s; "
            "span medians "
            + ", ".join(f"{n} {v:.4f} s" for n, v in spans.items()))
        return {"design_s": window.seconds / max(1, len(reqs))}

    def report_lines(self):
        return self._lines

    # -- correctness ------------------------------------------------------

    def compare(self) -> dict:
        """The compared numbers (see the module's docstring)."""
        import torch

        from perfbench.reference import k2

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
        t_guided = time.perf_counter() - t_ref
        r = reqs[slowest]
        t_roll = time.perf_counter()
        raw = np.stack(ref["rollout"](r["samples"], r["object"]))
        t_roll = time.perf_counter() - t_roll
        got = r["raw"]
        poses = torch.as_tensor(self._poses()[1])

        def view(a):
            dth, sdpos, fth, valid, fdpos = k2.readout(
                *(torch.as_tensor(x) for x in a[:9]), poses)
            return (dth.numpy(), sdpos.numpy(), fth.numpy(), valid.numpy(),
                    fdpos.numpy())

        g_dth, g_sdpos, g_fth, g_valid, g_fdpos = view(got)
        r_dth, r_sdpos, r_fth, r_valid, r_fdpos = view(raw)
        two_pi = 2.0 * math.pi
        dfth = np.abs(g_fth - r_fth)
        dfth = np.minimum(dfth, two_pi - dfth)
        ddth = np.abs(g_dth - r_dth)
        ddth = np.minimum(ddth, two_pi - ddth)
        # a rollout whose validity, or whose block's step counters, differ
        # from the reference's counts as the widest angle gap
        flags = np.any(got[COUNTERS] != raw[COUNTERS], axis=0) \
            | (g_valid != r_valid)
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
            f"compared: guidance of requests {picks} of {len(reqs)} "
            f"({t_guided:.1f} s); verification and table of request "
            f"{slowest} ({r['objective']}, "
            f"{self.cfg['objects'][r['object']]}); "
            f"rollouts with another validity or step counters "
            f"{int(flags.sum())}; reference rollout {t_roll:.1f} s, all "
            f"{time.perf_counter() - t_ref:.1f} s")
        return {
            "samples_gap": gap,
            "dtheta_gap_rad": float(np.where(flags, math.pi, ddth).max()),
            "final_theta_gap_rad": float(np.where(flags, math.pi,
                                                  dfth).max()),
            "pos_gap_m": float(max(np.abs(g_sdpos - r_sdpos).max(),
                                   np.abs(g_fdpos - r_fdpos).max())),
            "table_gap": table_gap,
        }
