"""mfu.datagen: K2's counted float32 operations of every wave of the
window (from its step counters, ``perfbench/counts.py``) over the window's
seconds at the card's float32 peak (67 TFLOP/s)."""

from perfbench import counts


def read(window):
    calls = window.records.get("k2") or []
    if not calls or window.kernels is None:
        return None
    work = sum(counts.k2_flops(c["p"], c["steps"], c["cfull"], c["ccheap"],
                               c["citer"]) for c in calls)
    return 100.0 * work / (window.seconds * counts.PEAK_F32_FLOPS)
