"""finger_build_ms: the program's ``scene.fingers`` spans in the window
(both fingers of each ``make_scene``: the cache lookup and, on a miss, the
coefficients and the jaw mass), per completed request
(``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(window):
    reqs = window.records.get("requests") or []
    total = program_spans.seconds(window, "scene.fingers")
    if not reqs or total is None:
        return None
    return 1e3 * total / len(reqs)
