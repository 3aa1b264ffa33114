"""idle_share.design: the share of the window in which no kernel, copy or
set ran on the device (the union of their intervals in the trace)."""


def read(window):
    if window.busy_s is None or window.seconds <= 0.0:
        return None
    return 100.0 * (1.0 - window.busy_s / window.seconds)
