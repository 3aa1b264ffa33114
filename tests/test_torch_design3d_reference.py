"""The port's 3D design models and guided sampler against the benchmark's
plain reference (``perfbench/reference``: frozen copies that import nothing
of the port), on seeded random weights at a small size on the CPU:

- ``ProfileForward3D`` and its ``PointNet2`` encoder give the reference's
  outputs bit for bit (the object features, the trunk's deltas), at the
  published encoder levels and a cut trunk width;
- one 3D guided request through ``GuidedSampler`` (the fused sweep for a
  plain objective, the convergence path) gives ``reference/guided.py``'s
  samples bit for bit, and opens one ``guidance.encode`` span per object
  encoding;
- the verification's host build of a design's jaws, the surface fits of
  the hull envelope (``fit_surface_batch``, whose envelope evaluates each
  slab patch over its own footprint) and the hull masses
  (``finger_masses_3d``), is the reference's bit for bit.
"""

import numpy as np
import pytest
import torch

from dgdm_tpu_torch.core.config import GUIDANCE, NORM
from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.design.guidance import GuidedSampler
from dgdm_tpu_torch.geom.fingers import denormalize_y
from dgdm_tpu_torch.models.pointnet2 import PointNet2
from dgdm_tpu_torch.models.profile3d import ProfileForward3D
from dgdm_tpu_torch.models.unet1d import ConditionalUnet1D
from dgdm_tpu_torch.sim import engine3d
from dgdm_tpu_torch.sim.surface_fit import fit_surface_batch
from dgdm_tpu_torch.train import generator
from perfbench import weights
from perfbench.reference import guided as ref_guided
from perfbench.reference import scene3d as ref_scene3d
from perfbench.reference import surface_fit as ref_surface_fit
from perfbench.reference.pointnet2 import PointNet2 as RefPointNet2
from perfbench.reference.profile3d import ProfileForward3D as RefProfile3D
from perfbench.reference.unet1d import ConditionalUnet1D as RefUnet
from tests import torch_parity  # noqa: F401  (one torch thread)

CPU = torch.device("cpu")
WIDTH = 32
UNET = dict(input_dim=1, down_dims=[16, 32], diffusion_step_embed_dim=32,
            kernel_size=5, n_groups=4)
GRID, NUM_POS, BATCH, CTRL = 6, 2, 2, 42


def _cloud(seed, n=512):
    """A normalized object cloud (n, 3) in [-1, 1]."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)), dtype=torch.float32)


def _pair(port_cls, ref_cls, seed, **kw):
    """The port's and the reference's model with one seeded state."""
    state = weights.seeded_state(ref_cls(**kw), seed, CPU)
    port = weights.load(port_cls(**kw), state).eval()
    ref = weights.load(ref_cls(**kw), state).eval()
    return port, ref


@pytest.fixture
def tracer():
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()
        TRACER.start()
        TRACER.stop()


def test_pointnet2_matches_the_reference():
    port, ref = _pair(PointNet2, RefPointNet2, 7, width=WIDTH)
    clouds = torch.stack([_cloud(1), _cloud(2)])
    with torch.no_grad():
        a, b = port(clouds), ref(clouds)
    assert a.shape == (2, WIDTH)
    assert torch.equal(a, b)


def test_profile3d_matches_the_reference():
    kw = dict(width=WIDTH, params_ch=CTRL, output_ch=3, multires=4)
    port, ref = _pair(ProfileForward3D, RefProfile3D, 11, **kw)
    rng = np.random.default_rng(3)
    rows = 10
    ctrl = torch.as_tensor(rng.uniform(-1, 1, (rows, CTRL)),
                           dtype=torch.float32)
    ori = torch.as_tensor(rng.uniform(-1, 1, (rows, 1)), dtype=torch.float32)
    pos = torch.as_tensor(rng.uniform(-1, 1, (rows, 2)), dtype=torch.float32)
    t = torch.full((rows,), 0.4)
    with torch.no_grad():
        fa = port.encode_object(_cloud(5)[None])
        fb = ref.encode_object(_cloud(5)[None])
        da = port.trunk(ctrl, ori, pos, t, fa)
        db = ref.trunk(ctrl, ori, pos, t, fb)
    assert torch.equal(fa, fb)
    assert torch.equal(da, db)
    assert float(da.abs().max()) > 0.0


@pytest.mark.parametrize("objective", ["rotate", "shift_up", "convergence"])
def test_guided_request_matches_the_reference(tracer, objective):
    unet, ref_unet = _pair(ConditionalUnet1D, RefUnet, 20240223, **UNET)
    kw = dict(width=WIDTH, params_ch=CTRL, output_ch=3, multires=4)
    cls, ref_cls = _pair(ProfileForward3D, RefProfile3D, 20240224, **kw)
    for m in (ref_unet, ref_cls):
        m.requires_grad_(False)
    cloud = _cloud(9)
    noise = torch.randn((BATCH, CTRL, 1),
                        generator=torch.Generator().manual_seed(5))
    sub_bs = 4
    n_poses = GRID * NUM_POS ** 2
    sampler = GuidedSampler(unet, cls, grid_size=GRID, num_pos=NUM_POS,
                            num_train_timesteps=15, num_inference_steps=5,
                            pose_chunks=max(1, -(-n_poses // sub_bs)),
                            device=CPU)
    thr0 = float(NORM.threshold_std(True)[0])
    scale = GUIDANCE.scale(True, objective)
    if objective == "convergence":
        base = generator.sample(unet, noise, 15, 5)
        centers = sampler.find_convergence_centers(base, cloud, thr0)
        got = sampler.sample(noise, cloud, objective, scale, centers=centers)
        encodings = 2
    else:
        feats, w, rsq, sc, _ = sampler.sweep_inputs([objective], cloud[None],
                                                    True)
        got = sampler.sample_sweep(noise, feats, w, rsq, sc)[0]
        encodings = 1
    want = ref_guided.guided(ref_unet, ref_cls, noise, cloud, objective,
                             scale, GRID, NUM_POS, 15, 5, thr0, sub_bs)
    assert torch.equal(got, want)
    assert float((got - noise).abs().max()) > 0.0
    names = [s[0] for s in tracer.spans()]
    assert names.count("guidance.encode") == encodings


def test_jaw_fits_and_masses_match_the_reference():
    ys = np.asarray(denormalize_y(np.random.default_rng(13).uniform(
        -1.0, 1.0, (3, 2 * 21)), fingers_3d=True)).astype(np.float32)
    jaws = np.concatenate([ys[:, :21], ys[:, 21:]]).reshape(6, 7, 3)
    sides = ["upper"] * 3 + ["lower"] * 3
    fits = fit_surface_batch(jaws, sides=sides)
    assert np.array_equal(
        fits, ref_surface_fit.fit_surface_batch(jaws, sides=sides))
    assert float(np.ptp(fits)) > 0.0
    for y in ys:
        assert np.array_equal(engine3d.finger_masses_3d(y[:21], y[21:]),
                              ref_scene3d.finger_masses_3d(y[:21], y[21:]))
