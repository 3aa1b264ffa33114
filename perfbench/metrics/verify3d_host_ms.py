"""verify3d_host_ms: the host's part of a 3D verification call, per
completed request: the program's ``simeval3d.object`` (the object's mass
properties and contact points), ``simeval3d.scenes`` (the ``make_scene``
calls: the jaws' hull masses, and ``stack_scenes``), ``simeval3d.arrays``
(``rollout3d.scene_arrays_3d``: the surface fits, the broad-phase extrema,
the uploads) and ``simeval3d.metrics`` (the metric dicts) spans in the
window (``perfbench/program_spans.py``)."""

from perfbench import program_spans

SPANS = ("simeval3d.object", "simeval3d.scenes", "simeval3d.arrays",
         "simeval3d.metrics")


def read(window):
    reqs = window.records.get("requests") or []
    total = program_spans.seconds(window, *SPANS)
    if not reqs or total is None:
        return None
    return 1e3 * total / len(reqs)
