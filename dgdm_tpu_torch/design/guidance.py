"""Classifier-guided DDIM sampling — port of ``dgdm_tpu/design/guidance.py``.

Per denoising step (reference ``generator/diffusion.py:541-709``): UNet
epsilon, the gradient of the summed objective over the 360 x 5 x 5 pose grid
through the frozen dynamics classifier (``torch.autograd.grad``, chunked
over poses to bound the live-activation footprint), the epsilon correction
``eps <- eps - sqrt(1 - abar_t) * grad * scale``, and the DDIM update.

The models carry their weights (``nn.Module``s in ``eval()`` mode, loaded
with ``models/convert.py``), so the methods take no parameter trees. Plain
matrix products stay torch ops, as the JAX package leaves them to XLA.

With a ``mesh`` (``parallel/mesh.make_mesh``, one process a GPU) the pose
grid shards over its ``sp`` axis, as the JAX sampler's does: each sp rank
takes its contiguous block of the poses (and the matching rows of
per-pose objective weights), and the (B, L) gradient is summed over the sp
group (JAX's ``psum``; no autograd runs through the collective). The block
is the memory bound there, so ``pose_chunks`` collapses to 1. Every rank
returns the same samples; the dp axis replicates the loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dgdm_tpu_torch.core.config import DIFFUSION, GUIDANCE
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.design.objectives import (
    SIMPLE_OBJECTIVES,
    convergence_centers,
)
from dgdm_tpu_torch.diffusion import ddim
from dgdm_tpu_torch.parallel import mesh as meshlib


def pose_grid_normalized(
    grid_size: int, num_pos: int, ori_range: Tuple[float, float] = (-1.0, 1.0)
) -> np.ndarray:
    """(N, 3) normalized poses [ori, x, y], meshgrid-ordered like the
    reference cond_fn (ori-major, then x, then y)."""
    ori = np.linspace(ori_range[0], ori_range[1], grid_size)
    xy = np.linspace(-1.0, 1.0, num_pos)
    o, x, y = np.meshgrid(ori, xy, xy, indexing="ij")
    return np.stack([o.reshape(-1), x.reshape(-1), y.reshape(-1)], -1).astype(
        np.float32
    )


class GuidedSampler2D:
    """The frozen dynamics classifier and the (EMA) denoiser, bundled into
    guided DDIM sampling. The classifier exposes ``encode_object``/``trunk``
    (models/profile2d.py); the object is encoded once per sampling call."""

    def __init__(
        self,
        unet: torch.nn.Module,
        classifier: torch.nn.Module,
        grid_size: int = GUIDANCE.grid_size_2d,
        num_pos: int = GUIDANCE.num_pos,
        num_train_timesteps: int = DIFFUSION.num_train_timesteps,
        num_inference_steps: int = DIFFUSION.num_inference_steps,
        pose_chunks: int = 12,
        device="cuda",
        mesh=None,
    ):
        self.device = torch.device(device)
        self.unet = unet.to(self.device).eval().requires_grad_(False)
        self.classifier = classifier.to(self.device).eval() \
            .requires_grad_(False)
        self.sched = ddim.make_schedule(num_train_timesteps)
        self.num_train_timesteps = num_train_timesteps
        self.num_inference_steps = num_inference_steps
        self.grid_size = grid_size
        self.num_pos = num_pos
        self.mesh = mesh
        self.pose_chunks = 1 if mesh is not None else pose_chunks

    # -- plumbing -------------------------------------------------------------

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    def _poses(self, ori_range) -> torch.Tensor:
        return self._tensor(
            pose_grid_normalized(self.grid_size, self.num_pos, ori_range))

    def _schedule(self):
        return zip(
            ddim.inference_timesteps(self.num_train_timesteps,
                                     self.num_inference_steps).tolist(),
            ddim.prev_timesteps(self.num_train_timesteps,
                                self.num_inference_steps).tolist())

    def _t_resc(self, t: int) -> torch.Tensor:
        return torch.tensor(float(t), dtype=torch.float32,
                            device=self.device) / self.num_train_timesteps

    @TRACER.traced("guidance.eps")
    def _eps(self, x: torch.Tensor, t: int) -> torch.Tensor:
        with torch.no_grad():
            tb = torch.full((x.shape[0],), t, dtype=torch.int64,
                            device=self.device)
            return self.unet(x, tb)

    def _guided_step(self, x, t, pt, g, scale):
        abar = self.sched.alphas_cumprod[t].to(self.device)
        eps = self._eps(x.reshape(-1, *x.shape[-2:]), t).reshape(x.shape)
        eps = eps - torch.sqrt(1.0 - abar) * g * scale
        return ddim.ddim_step(self.sched, eps, t, pt, x)

    def _encode_object(self, obj: torch.Tensor) -> torch.Tensor:
        """obj (obj_dims...) -> (W,) feature."""
        with torch.no_grad():
            return self.classifier.encode_object(obj[None])[0]

    def _objective_weights(
        self, objective: str, centers: Optional[torch.Tensor], batch: int
    ) -> Tuple[torch.Tensor, bool]:
        """Linear weights w (N, 1-or-B, 3) with objective = sum w*deltas
        (square of component 0 instead for 'rotate')."""
        n = self.grid_size * self.num_pos**2
        if objective == "rotate":
            return torch.zeros((), device=self.device), True
        if objective == "convergence":
            if centers is None:
                raise ValueError("objective 'convergence' needs centers")
            centers = torch.as_tensor(centers, device=self.device)
            gidx = torch.arange(n, device=self.device) // (self.num_pos**2)
            off = (gidx[None, :] - centers[:, None] + self.grid_size // 2) \
                % self.grid_size - self.grid_size // 2            # (B, N)
            sign = torch.where(off < 0, 1.0, -1.0)
            w = torch.zeros((batch, n, 3), device=self.device)
            w[..., 0] = sign
            return w.permute(1, 0, 2), False                      # (N, B, 3)
        base = SIMPLE_OBJECTIVES[objective](torch.eye(3, device=self.device))
        return base.expand(n, 1, 3), False

    def _local_poses(self, poses: torch.Tensor, weights=None):
        """This sp rank's block of the pose grid (and of per-pose weights
        (N, ...)); everything without a mesh."""
        n = poses.shape[0]
        if self.mesh is None or self.mesh.size("sp") == 1:
            return poses, weights
        if n % self.mesh.size("sp"):
            raise ValueError(f"{n} poses do not split over "
                             f"sp = {self.mesh.size('sp')}")
        sl = meshlib.block(self.mesh, n, "sp")
        if weights is not None and weights.ndim == 3 and \
                weights.shape[0] == n:
            weights = weights[sl]
        return poses[sl], weights

    # -- guidance gradient ----------------------------------------------------

    @TRACER.traced("guidance.grad")
    def cond_grad(self, x: torch.Tensor, t: int, obj_feat: torch.Tensor,
                  weights: torch.Tensor, rotate_sq: bool,
                  poses: torch.Tensor) -> torch.Tensor:
        """d(sum objective over pose grid)/dx. x (B, L, 1); poses (N, 3);
        obj_feat (W,) precomputed object feature."""
        poses, weights = self._local_poses(poses, weights)
        b, l, _ = x.shape
        n = poses.shape[0]
        # largest divisor of n not exceeding the requested chunk count
        chunks = max(
            (c for c in range(1, min(self.pose_chunks, n) + 1) if n % c == 0),
            default=1,
        )
        chunk = n // chunks
        per_pose = weights.ndim == 3 and weights.shape[0] == n
        t_resc = self._t_resc(t)
        xf = x[..., 0].detach().requires_grad_(True)
        grads = []
        with torch.enable_grad():
            for ci in range(chunks):
                pc = poses[ci * chunk:(ci + 1) * chunk]
                c = pc.shape[0]
                ctrl = xf[None].expand(c, b, l).reshape(c * b, l)
                ori = pc[:, 0:1].repeat_interleave(b, dim=0)
                pos = pc[:, 1:3].repeat_interleave(b, dim=0)
                tt = t_resc.expand(c * b)
                deltas = self.classifier.trunk(
                    ctrl, ori, pos, tt, obj_feat[None]).reshape(c, b, 3)
                if rotate_sq:
                    obj = torch.sum(deltas[..., 0] ** 2)
                else:
                    w = weights[ci * chunk:(ci + 1) * chunk] if per_pose \
                        else weights
                    obj = torch.sum(w * deltas)
                grads.append(torch.autograd.grad(obj, xf)[0])
        g = torch.stack(grads).sum(0)[..., None]                  # (B, L, 1)
        return meshlib.all_reduce_sum(self.mesh, g, "sp")

    @TRACER.traced("guidance.grad")
    def _sweep_grad(self, x, t, obj_feats, weights, rsq, poses,
                    row_budget: int = 65536) -> torch.Tensor:
        """d(sum objective)/dx for K fused (objective, object) pairs.
        x (K, B, L, 1); obj_feats (K, W); weights (K, 3); rsq (K,); the pose
        axis is chunked so each trunk call sees ~row_budget rows."""
        poses, _ = self._local_poses(poses)
        k, b, l, _ = x.shape
        n = poses.shape[0]
        w_feat = obj_feats.shape[-1]
        max_chunk = max(1, row_budget // max(1, k * b))
        chunks = min(
            (c for c in range(1, n + 1) if n % c == 0 and n // c <= max_chunk),
            default=n,
        )
        chunk = n // chunks
        t_resc = self._t_resc(t)
        xf = x[..., 0].detach().requires_grad_(True)
        grads = []
        with torch.enable_grad():
            for ci in range(chunks):
                pc = poses[ci * chunk:(ci + 1) * chunk]
                c = pc.shape[0]
                ctrl = xf[:, None].expand(k, c, b, l).reshape(k * c * b, l)
                ori = pc[:, 0:1].repeat_interleave(b, dim=0).repeat(k, 1)
                pos = pc[:, 1:3].repeat_interleave(b, dim=0).repeat(k, 1)
                feat = obj_feats[:, None, None].expand(k, c, b, w_feat) \
                    .reshape(k * c * b, w_feat)
                tt = t_resc.expand(k * c * b)
                deltas = self.classifier.trunk(ctrl, ori, pos, tt, feat) \
                    .reshape(k, c, b, 3)
                lin = torch.sum(weights[:, None, None, :] * deltas, dim=-1)
                obj = torch.sum(lin + rsq[:, None, None] * deltas[..., 0] ** 2)
                grads.append(torch.autograd.grad(obj, xf)[0])
        g = torch.stack(grads).sum(0)[..., None]               # (K, B, L, 1)
        return meshlib.all_reduce_sum(self.mesh, g, "sp")

    # -- guided sampling ------------------------------------------------------

    def sample(self, noise, obj_flat, objective: str, scale: float,
               centers=None, ori_range=(-1.0, 1.0)) -> torch.Tensor:
        """One guided DDIM run. noise (B, L, 1) -> samples (B, L, 1)."""
        with TRACER.span("guidance.inputs"):
            x = self._tensor(noise)
            poses = self._poses(ori_range)
            weights, rotate_sq = self._objective_weights(objective, centers,
                                                         x.shape[0])
            obj_feat = self._encode_object(self._tensor(obj_flat))
            scale = self._tensor(scale)
        for t, pt in self._schedule():
            with TRACER.span("guidance.step"):
                g = self.cond_grad(x, t, obj_feat, weights, rotate_sq, poses)
                x = self._guided_step(x, t, pt, g, scale)
        return x

    def sample_sweep(self, noise, obj_feats, weights, rsq, scales,
                     ori_range=(-1.0, 1.0)) -> torch.Tensor:
        """Fused guided sampling over K (objective, object) pairs: the UNet
        runs K*B-row batches and the classifier gradient K*chunk*B rows per
        denoise step. Returns (K, B, L, 1). 'convergence' stays on
        ``sample``."""
        with TRACER.span("guidance.inputs"):
            noise = self._tensor(noise)
            k = obj_feats.shape[0]
            poses = self._poses(ori_range)
            x = noise[None].expand(k, *noise.shape).clone()
            scales = self._tensor(scales)[:, None, None, None]
        for t, pt in self._schedule():
            with TRACER.span("guidance.step"):
                g = self._sweep_grad(x, t, obj_feats, self._tensor(weights),
                                     self._tensor(rsq), poses)
                x = self._guided_step(x, t, pt, g, scales)
        return x

    @TRACER.traced("guidance.inputs")
    def sweep_inputs(self, objectives: Sequence[str], obj_flats,
                     fingers_3d: bool):
        """(obj_feats, weights, rsq, scales, labels) for sample_sweep from
        objective names x objects; skips 'convergence'; labels[i] =
        (objective, object_index)."""
        with torch.no_grad():
            feats = self.classifier.encode_object(self._tensor(obj_flats))
        labels, w_rows, r_rows, s_rows, f_rows = [], [], [], [], []
        for name in objectives:
            if name == "convergence":
                continue
            if name == "rotate":
                w, r = np.zeros(3, np.float32), 1.0
            else:
                w = np.asarray(SIMPLE_OBJECTIVES[name](np.eye(3)), np.float32)
                r = 0.0
            s = float(GUIDANCE.scale(fingers_3d, name))
            for oi in range(feats.shape[0]):
                labels.append((name, oi))
                w_rows.append(w)
                r_rows.append(r)
                s_rows.append(s)
                f_rows.append(feats[oi])
        return (torch.stack(f_rows), self._tensor(np.stack(w_rows)),
                self._tensor(np.asarray(r_rows, np.float32)),
                self._tensor(np.asarray(s_rows, np.float32)), labels)

    def sample_multi_object(self, noise, obj_flats, objective: str,
                            scale: float,
                            ori_range=(-1.0, 1.0)) -> torch.Tensor:
        """Gradient averaged over objects (generator/diffusion.py:621-709)."""
        with TRACER.span("guidance.inputs"):
            x = self._tensor(noise)
            poses = self._poses(ori_range)
            weights, rotate_sq = self._objective_weights(objective, None,
                                                         x.shape[0])
            with torch.no_grad():
                obj_feats = self.classifier.encode_object(
                    self._tensor(obj_flats))
            scale = self._tensor(scale)
        for t, pt in self._schedule():
            with TRACER.span("guidance.step"):
                g = torch.mean(torch.stack([
                    self.cond_grad(x, t, of, weights, rotate_sq, poses)
                    for of in obj_feats]), dim=0)
                x = self._guided_step(x, t, pt, g, scale)
        return x

    def profile_classes(self, x, obj_flat, threshold_std0: float,
                        ori_range=(-1.0, 1.0)) -> torch.Tensor:
        """Classifier orientation profile at pos=(0,0), t=0 -> classes (B, G)."""
        x = self._tensor(x)
        b, l, _ = x.shape
        g = self.grid_size
        ori = self._tensor(np.linspace(ori_range[0], ori_range[1], g))
        ctrl = x[..., 0][None].expand(g, b, l).reshape(g * b, l)
        orif = ori[:, None].repeat_interleave(b, dim=0)
        pos = torch.zeros((g * b, 2), device=self.device)
        tt = torch.zeros((g * b,), device=self.device)
        with torch.no_grad():
            obj_feat = self._encode_object(self._tensor(obj_flat))
            d0 = self.classifier.trunk(ctrl, orif, pos, tt,
                                       obj_feat[None])[..., 0]
        d0 = d0.reshape(g, b).T                                   # (B, G)
        thr = float(np.float32(threshold_std0))
        return torch.where(d0 > thr, 2, torch.where(d0 < -thr, 0, 1))

    @TRACER.traced("guidance.centers")
    def find_convergence_centers(self, unguided, obj_flat,
                                 threshold_std0: float) -> torch.Tensor:
        cls = self.profile_classes(unguided, obj_flat, threshold_std0)
        return convergence_centers(cls, self.grid_size)


# alias: the sampler is dimension-agnostic (2D/3D classifiers both work)
GuidedSampler = GuidedSampler2D
