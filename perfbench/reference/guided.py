"""Plain classifier-guided DDIM of the benchmark's reference (the design
loop of ``generator/diffusion.py:541-709``, as the program's
``design/guidance.py`` and ``train/generator.py`` run it): per denoising
step the UNet's epsilon, the gradient of the objective summed over the
whole pose grid through the frozen classifier (summed over pose chunks in
the sample CLI's order), the correction
``eps <- eps - sqrt(1 - abar_t) * grad * scale`` and the DDIM update.

``convergence`` re-centres each sample's objective on the orientation at
which the classifier's profile of the unguided sample changes from ccw to
cw (``objectives.convergence_centers``). Float32; the caller sets TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import ddim
from perfbench.reference.objectives import (
    SIMPLE_OBJECTIVES,
    convergence_centers,
)


def pose_grid_normalized(grid_size: int, num_pos: int) -> np.ndarray:
    """(N, 3) normalized poses [ori, x, y], ori-major, then x, then y."""
    ori = np.linspace(-1.0, 1.0, grid_size)
    xy = np.linspace(-1.0, 1.0, num_pos)
    o, x, y = np.meshgrid(ori, xy, xy, indexing="ij")
    return np.stack([o.reshape(-1), x.reshape(-1), y.reshape(-1)],
                    -1).astype(np.float32)


def _schedule(num_train: int, num_inference: int):
    return zip(ddim.inference_timesteps(num_train, num_inference).tolist(),
               ddim.prev_timesteps(num_train, num_inference).tolist())


@torch.no_grad()
def unguided(unet, noise, num_train: int, num_inference: int):
    """Plain DDIM: noise (B, L, 1) -> samples (B, L, 1)."""
    sched = ddim.make_schedule(num_train)
    x = noise
    for t, pt in _schedule(num_train, num_inference):
        tb = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        x = ddim.ddim_step(sched, unet(x, tb), t, pt, x)
    return x


@torch.no_grad()
def profile_classes(classifier, x, obj_flat, grid_size: int,
                    threshold0: float) -> torch.Tensor:
    """The classifier's orientation profile at pos (0, 0), t = 0, in three
    classes -> (B, G)."""
    b, l, _ = x.shape
    dev = x.device
    ori = torch.as_tensor(np.linspace(-1.0, 1.0, grid_size),
                          dtype=torch.float32, device=dev)
    ctrl = x[..., 0][None].expand(grid_size, b, l).reshape(grid_size * b, l)
    orif = ori[:, None].repeat_interleave(b, dim=0)
    pos = torch.zeros((grid_size * b, 2), device=dev)
    tt = torch.zeros((grid_size * b,), device=dev)
    feat = classifier.encode_object(obj_flat[None])
    d0 = classifier.trunk(ctrl, orif, pos, tt, feat)[..., 0]
    d0 = d0.reshape(grid_size, b).T
    thr = float(np.float32(threshold0))
    return torch.where(d0 > thr, 2, torch.where(d0 < -thr, 0, 1))


def objective_weights(objective: str, n: int, batch: int, grid_size: int,
                      num_pos: int, centers, device):
    """(w, rotate_sq): the objective is sum(w * deltas), or the sum of the
    squared component 0 for 'rotate'. w is (N, 1, 3), or (N, B, 3) for
    'convergence' (the sign of each orientation's offset from its
    sample's centre)."""
    if objective == "rotate":
        return torch.zeros((), device=device), True
    if objective == "convergence":
        gidx = torch.arange(n, device=device) // (num_pos ** 2)
        off = (gidx[None, :] - centers[:, None] + grid_size // 2) \
            % grid_size - grid_size // 2
        w = torch.zeros((batch, n, 3), device=device)
        w[..., 0] = torch.where(off < 0, 1.0, -1.0)
        return w.permute(1, 0, 2), False
    base = SIMPLE_OBJECTIVES[objective](torch.eye(3, device=device))
    return base.expand(n, 1, 3), False


def _chunks(n: int, max_poses: int) -> int:
    """The fewest equal pose chunks of at most ``max_poses`` poses."""
    return min((c for c in range(1, n + 1)
                if n % c == 0 and n // c <= max_poses), default=n)


def guided(unet, classifier, noise, obj_flat, objective: str, scale: float,
           grid_size: int, num_pos: int, num_train: int, num_inference: int,
           threshold0: float, sub_bs: int, row_budget: int = 65536):
    """One request's guided samples: noise (B, L, 1) -> (B, L, 1).

    The gradient is summed over pose chunks in the order the sample CLI
    sums it, so that the float32 sums agree: for the one-pair sweep, the
    fewest chunks of at most ``row_budget`` (pose, design) rows; for
    'convergence', the most chunks (at most ceil(N / ``sub_bs``)) that
    divide the grid."""
    dev = noise.device
    b, l, _ = noise.shape
    poses = torch.as_tensor(pose_grid_normalized(grid_size, num_pos),
                            device=dev)
    n = poses.shape[0]
    centers = None
    if objective == "convergence":
        base = unguided(unet, noise, num_train, num_inference)
        centers = convergence_centers(
            profile_classes(classifier, base, obj_flat, grid_size,
                            threshold0), grid_size)
        want = max(1, -(-n // max(sub_bs, 1)))
        n_chunks = max(c for c in range(1, min(want, n) + 1) if n % c == 0)
    else:
        n_chunks = _chunks(n, max(1, row_budget // b))
    w, rotate_sq = objective_weights(objective, n, b, grid_size, num_pos,
                                     centers, dev)
    per_pose = w.ndim == 3 and w.shape[0] == n
    with torch.no_grad():
        feat = classifier.encode_object(obj_flat[None])
    sched = ddim.make_schedule(num_train)
    scale_t = torch.tensor(scale, dtype=torch.float32, device=dev)
    chunk = n // n_chunks
    x = noise
    for t, pt in _schedule(num_train, num_inference):
        xf = x[..., 0].detach().requires_grad_(True)
        t_resc = torch.tensor(float(t), dtype=torch.float32,
                              device=dev) / num_train
        grads = []
        with torch.enable_grad():
            for ci in range(n_chunks):
                pc = poses[ci * chunk:(ci + 1) * chunk]
                ctrl = xf[None].expand(chunk, b, l).reshape(chunk * b, l)
                ori = pc[:, 0:1].repeat_interleave(b, dim=0)
                pos = pc[:, 1:3].repeat_interleave(b, dim=0)
                tt = t_resc.expand(chunk * b)
                deltas = classifier.trunk(ctrl, ori, pos, tt, feat) \
                    .reshape(chunk, b, 3)
                if per_pose:
                    obj = torch.sum(w[ci * chunk:(ci + 1) * chunk] * deltas)
                else:
                    # the sweep's objective: linear weights plus the
                    # squared rotation for 'rotate'
                    rsq = 1.0 if rotate_sq else 0.0
                    wl = torch.zeros(3, device=dev) if rotate_sq else w[0, 0]
                    obj = torch.sum(torch.sum(wl * deltas, dim=-1)
                                    + rsq * deltas[..., 0] ** 2)
                grads.append(torch.autograd.grad(obj, xf)[0])
        g = torch.stack(grads).sum(0)[..., None]
        with torch.no_grad():
            tb = torch.full((b,), t, dtype=torch.int64, device=dev)
            abar = sched.alphas_cumprod[t].to(dev)
            eps = unet(x, tb) - torch.sqrt(1.0 - abar) * g * scale_t
            x = ddim.ddim_step(sched, eps, t, pt, x)
    return x
