"""verify_scene_ms: the program's host work before K1 can start, per
completed request: its ``simeval.scenes`` spans (denormalise, the pose grid
and its upload, the ``make_scene`` calls, ``stack_scenes``) and
``simeval.arrays`` spans (``rollout2d.scene_arrays``: host arrays and
pinned uploads) in the window (``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(window):
    reqs = window.records.get("requests") or []
    total = program_spans.seconds(window, "simeval.scenes", "simeval.arrays")
    if not reqs or total is None:
        return None
    return 1e3 * total / len(reqs)
