"""mfu.design3d: the counted float32 work of every 3D design request of the
window over the window's seconds at the card's float32 peak (67 TFLOP/s):
per DDIM step the 3D classifier's forward pass and input-gradient backward
pass over every (pose, design) row and the UNet over the designs; the
PointNet++ encodings of the object (one a request; 'convergence' encodes
it again for the orientation profile); for 'convergence' also the unguided
DDIM and the classifier's orientation profile; and K2's counted operations
from its step counters (``perfbench/counts.py``, ``counts3d.py``)."""

from perfbench import counts, counts3d


def read(window):
    reqs = window.records.get("requests") or []
    if not reqs or window.kernels is None:
        return None
    cfg = window.config
    fwd, bwd = counts3d.classifier3d_row_flops(cfg)
    encode = counts3d.pointnet2_flops(cfg)
    unet = counts.unet_sample_flops(cfg["unet"], cfg["ctrlpts_dim"])
    steps = cfg["num_inference_steps"]
    poses = cfg["grid_size"] * cfg["num_pos"] ** 2
    work = 0.0
    for r in reqs:
        b = r["samples"].shape[0]
        work += steps * (b * poses * (fwd + bwd) + b * unet) + encode
        if r["objective"] == "convergence":
            work += steps * b * unet + cfg["grid_size"] * b * fwd + encode
    for c in window.records.get("k2") or []:
        work += counts.k2_flops(c["p"], c["steps"], c["cfull"], c["ccheap"],
                                c["citer"])
    return 100.0 * work / (window.seconds * counts.PEAK_F32_FLOPS)
