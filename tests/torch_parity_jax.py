"""Helpers of the port's rollout tests that need the JAX package: the Pallas
kernels K1 and K2 in interpret mode on the CPU as the reference, and the
small scenes both packages build for them (tests/torch_parity.py stays free
of JAX for the card's tests)."""

import os
from unittest import mock

import numpy as np
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import torch

from dgdm_tpu.geom import mesh3d as jmesh
from dgdm_tpu.geom.contour import extract_contours
from dgdm_tpu.geom.fingers import sample_gripper_2d, sample_gripper_3d
from dgdm_tpu.sim import engine2d as jeng2
from dgdm_tpu.sim import engine3d as jeng3
from dgdm_tpu.sim import pallas3d
from dgdm_tpu_torch.sim import datagen as tdatagen
from dgdm_tpu_torch.sim import engine2d as teng2
from dgdm_tpu_torch.sim import engine3d as teng3
from dgdm_tpu_torch.sim import rollout3d
from tests.util_icons import make_icon

MUG = os.path.join(os.path.dirname(__file__), "fixtures", "scanned_objects",
                   "mug_small", "model.obj")


def interpret(pallas_module):
    """Context: ``pl.pallas_call`` of a JAX kernel module runs in interpret
    mode, as the JAX package's own tests run it on the CPU."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    return mock.patch.object(pallas_module.pl, "pallas_call", interp)


def circle_poses(n=128):
    """(n, 3) float32 poses at the origin, orientations over [0, 2 pi)."""
    ths = np.linspace(0, 2 * np.pi, n, endpoint=False).astype(np.float32)
    return np.stack([np.zeros(n), np.zeros(n), ths], -1).astype(np.float32)


def k1_scenes():
    """2 grippers x icon 3 (100 contour points) as stacked scenes of each
    package, and 128 poses."""
    contour = extract_contours(make_icon(3))
    grips = [sample_gripper_2d(i) for i in range(2)]
    jst = jax.tree.map(lambda *xs: jnp.stack(xs),
                       *[jeng2.make_scene(*g, contour) for g in grips])
    tst = tdatagen.stack_scenes([teng2.make_scene(*g, contour)
                                 for g in grips])
    return jst, tst, circle_poses()


def k2_scene_arrays():
    """Grippers 2-3 x mug_small, the scenes built on each side by its own
    package (one object_properties_3d per object, 256 contact points, as the
    verification and datagen callers build them): the JAX kernel's arrays,
    the port's (CPU tensors) and 128 poses."""
    verts, faces = jmesh.load_obj(MUG)
    grips = [sample_gripper_3d(i) for i in (2, 3)]
    jp = jeng3.object_properties_3d(verts, faces)
    jst = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jeng3.make_scene(*g, verts, faces, obj_props=jp) for g in grips])
    tp = teng3.object_properties_3d(verts, faces)
    tst = tdatagen.stack_scenes([
        teng3.make_scene(*g, verts, faces, obj_props=tp) for g in grips])
    return pallas3d.scene_arrays_3d(jst), \
        rollout3d.scene_arrays_3d(tst, device="cpu"), circle_poses()


def k2_profiles(res, mix=None):
    """(dth, snapshot dpos, final theta, valid, final dpos[, counters]) of
    either package -> numpy profile dict."""
    dth, sdpos, fth, valid, fpos = (np.asarray(r) for r in res)
    out = {"dth": dth, "dpx": sdpos[..., 0], "dpy": sdpos[..., 1],
           "fth": fth, "fpx": fpos[..., 0], "fpy": fpos[..., 1],
           "valid": valid}
    if mix is not None:
        out.update(zip(("cfull", "ccheap", "citer"),
                       (np.asarray(m) for m in mix)))
    return out


def k2_pallas(jarrs, poses, steps, rg, snap):
    """The Pallas kernel K2 (interpret mode) -> profile dict with counters."""
    with interpret(pallas3d):
        *res, mix = pallas3d.profile_batch_pallas3d(
            *jarrs, jnp.asarray(poses), steps=steps, regrasp_every=rg,
            snapshot_step=snap, return_step_mix=True)
    return k2_profiles(res, mix)


def k2_pallas_case(schedule):
    """The port's scene arrays, the poses (tensor) and the Pallas kernel's
    profiles at ``schedule`` = (steps, regrasp_every, snapshot_step)."""
    jarrs, tarrs, poses = k2_scene_arrays()
    return tarrs, torch.from_numpy(poses), k2_pallas(jarrs, poses, *schedule)
