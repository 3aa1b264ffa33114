"""mfu.design: the counted float32 work of every design request of the
window over the window's seconds at the card's float32 peak (67 TFLOP/s):
per DDIM step the classifier's forward pass and input-gradient backward
pass over every (pose, design) row and the UNet over the designs; for
'convergence' also the unguided DDIM and the classifier's orientation
profile; and K1's counted operations from its step counters
(``perfbench/counts.py``)."""

from perfbench import counts


def read(window):
    reqs = window.records.get("requests") or []
    if not reqs or window.kernels is None:
        return None
    cfg = window.config
    fwd, bwd = counts.classifier_row_flops(cfg["classifier"])
    unet = counts.unet_sample_flops(cfg["unet"], cfg["ctrlpts_dim"])
    steps = cfg["num_inference_steps"]
    poses = cfg["grid_size"] * cfg["num_pos"] ** 2
    work = 0.0
    for r in reqs:
        b = r["samples"].shape[0]
        work += steps * (b * poses * (fwd + bwd) + b * unet)
        if r["objective"] == "convergence":
            work += steps * b * unet + cfg["grid_size"] * b * fwd
    for c in window.records.get("k1") or []:
        work += counts.k1_flops(c["p"], c["s"], c["steps"], c["cfull"],
                                c["ccheap"])
    return 100.0 * work / (window.seconds * counts.PEAK_F32_FLOPS)
