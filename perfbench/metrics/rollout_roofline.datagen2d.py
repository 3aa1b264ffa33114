"""rollout_roofline.datagen2d: the share of its roofline that the 2D
rollout kernel K1 reaches in the 2D datagen window: the least time its work
could take (the larger of its counted float32 operations over 67 TFLOP/s
and its bytes over 3.35 TB/s, ``perfbench/counts.py``) over its device time
in the trace. The operations follow each launch's step counters, which the
traffic keeps one value a 128-lane block (every lane of a block holds its
block's count)."""

from perfbench import counts

KERNEL = "rollout2d_kernel"


def read(window):
    calls = window.records.get("k1") or []
    if not calls or window.kernels is None:
        return None
    device_s = window.kernel_seconds(KERNEL)
    if device_s <= 0.0:
        return None
    bound = sum(counts.bound_s(
        c["lanes_per_block"] * counts.k1_flops(c["p"], c["s"], c["steps"],
                                               c["cfull"], c["ccheap"]),
        counts.k1_bytes(c["b"], c["p"], c["s"], c["n"])) for c in calls)
    return 100.0 * bound / device_s
