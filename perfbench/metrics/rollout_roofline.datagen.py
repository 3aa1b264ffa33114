"""rollout_roofline.datagen: the share of its roofline that the 3D rollout
kernel K2 reaches in the window: the least time its work could take (the
larger of its counted float32 operations over 67 TFLOP/s and its bytes
over 3.35 TB/s, ``perfbench/counts.py``) over its device time in the
trace. The operations follow each launch's step counters."""

from perfbench import counts

KERNEL = "rollout3d_kernel"


def read(window):
    calls = window.records.get("k2") or []
    if not calls or window.kernels is None:
        return None
    device_s = window.kernel_seconds(KERNEL)
    if device_s <= 0.0:
        return None
    bound = sum(counts.bound_s(
        counts.k2_flops(c["p"], c["steps"], c["cfull"], c["ccheap"],
                        c["citer"]),
        counts.k2_bytes(c["b"], c["p"], c["n"])) for c in calls)
    return 100.0 * bound / device_s
