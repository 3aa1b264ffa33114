"""guidance_step_ms: the mean of the program's ``guidance.step`` spans in
the window: one guided DDIM step's host time (the UNet's epsilon, the
classifier's gradient over the pose grid, the update), which is the
step's enqueue where the host runs ahead of the card
(``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(window):
    steps = [e - s for n, s, e in program_spans.in_window(window)
             if n == "guidance.step"]
    if not steps:
        return None
    return 1e3 * sum(steps) / len(steps)
