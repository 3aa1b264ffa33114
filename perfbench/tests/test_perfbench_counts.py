"""The yardstick's counts, pinned on fixed small cases; the model counts
held against a count of the products that forward hooks see in the
reference models; a share above 100% is reported as it is."""

import json
import math
import os

import pytest
import torch

from perfbench import counts, harness


def _config(name):
    with open(os.path.join(harness.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_rollout_counts_pinned():
    assert counts.k1_flops(100, 64, 10, [[4]], [[3]]) == 427037.0
    assert counts.k1_bytes(2, 100, 64, 128) == 13888
    assert counts.k2_flops(256, 10, [[4]], [[3]], [[4]]) == 1469483.0
    assert counts.k2_bytes(2, 256, 128) == 26880
    # the bound is the larger of the two times
    assert counts.bound_s(67e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_s(1.0, 3.35e12) == pytest.approx(1.0)


def test_classifier_counts_pinned():
    fwd, bwd = counts.classifier_row_flops(_config("dgdm-2d")["classifier"])
    assert (fwd, bwd) == (1660928, 1464320)


def _hooked_flops(model, *args):
    """2 x the multiply-adds of every Linear, Conv1d and ConvTranspose1d
    that a forward pass runs, per row of its first argument."""
    total = [0]

    def hook(m, inputs, out):
        x = inputs[0]
        if isinstance(m, torch.nn.Linear):
            total[0] += 2 * m.in_features * m.out_features * (
                x.numel() // m.in_features)
        elif isinstance(m, torch.nn.ConvTranspose1d):
            total[0] += 2 * m.in_channels * m.out_channels \
                * m.kernel_size[0] * x.shape[0] * x.shape[-1]
        elif isinstance(m, torch.nn.Conv1d):
            total[0] += 2 * m.in_channels * m.out_channels \
                * m.kernel_size[0] * out.shape[0] * out.shape[-1]

    hs = [m.register_forward_hook(hook) for m in model.modules()]
    with torch.no_grad():
        model(*args)
    for h in hs:
        h.remove()
    return total[0] / args[0].shape[0]


def test_model_counts_match_the_reference_models():
    from perfbench.reference.profile2d import ProfileForward2D
    from perfbench.reference.unet1d import ConditionalUnet1D

    cfg = _config("dgdm-2d")
    unet = ConditionalUnet1D(**cfg["unet"]).eval()
    x = torch.zeros(3, cfg["ctrlpts_dim"], 1)
    seen = _hooked_flops(unet, x, torch.zeros(3, dtype=torch.int64))
    assert counts.unet_sample_flops(cfg["unet"], cfg["ctrlpts_dim"]) == seen
    cls = ProfileForward2D(**cfg["classifier"]).eval()
    rows = 5
    feat = cls.encode_object(torch.zeros(1, cfg["classifier"]["object_ch"]))

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.m = cls

        def forward(self, ctrl):
            return self.m.trunk(ctrl, torch.zeros(rows, 1),
                                torch.zeros(rows, 2), torch.zeros(rows),
                                feat)

    seen = _hooked_flops(Trunk(), torch.zeros(rows, 14))
    fwd, _ = counts.classifier_row_flops(cfg["classifier"])
    assert fwd == seen


def test_a_roofline_share_is_not_clipped():
    read = harness.metric_reader(
        harness.load_cell("dgdm-2d.design"), "rollout_roofline.verify")
    call = {"p": 100, "s": 64, "steps": 8000, "b": 16, "n": 384,
            "cfull": [[8000.0] * 384] * 16, "ccheap": [[0.0] * 384] * 16}
    bound = counts.bound_s(counts.k1_flops(100, 64, 8000, call["cfull"],
                                           call["ccheap"]),
                           counts.k1_bytes(16, 100, 64, 384))
    w = harness.Window(0.0, 1.0, harness.Spans(), {"k1": [call]}, {},
                       kernels=[("rollout2d_kernel<16, 0>", 0.0,
                                 0.5 * bound)], busy_s=0.5 * bound)
    assert read(w) == pytest.approx(200.0)
    assert not math.isnan(read(w))
