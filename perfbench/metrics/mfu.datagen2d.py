"""mfu.datagen2d: K1's counted float32 operations of every wave of the 2D
datagen window (from its step counters, one value a 128-lane block,
``perfbench/counts.py``) over the window's seconds at the card's float32
peak (67 TFLOP/s)."""

from perfbench import counts


def read(window):
    calls = window.records.get("k1") or []
    if not calls or window.kernels is None:
        return None
    work = sum(c["lanes_per_block"] * counts.k1_flops(
        c["p"], c["s"], c["steps"], c["cfull"], c["ccheap"]) for c in calls)
    return 100.0 * work / (window.seconds * counts.PEAK_F32_FLOPS)
