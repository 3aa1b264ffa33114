"""finger_build3d_ms: the 3D jaws' host work per completed request: the
program's ``scene3d.fingers`` spans (each ``make_scene``'s two hull masses,
``engine3d.finger_masses_3d``, the cache lookup included) and
``scene3d.fit`` spans (``fit_surface_batch`` on the fit cache's misses) in
the window (``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(window):
    reqs = window.records.get("requests") or []
    total = program_spans.seconds(window, "scene3d.fingers", "scene3d.fit")
    if not reqs or total is None:
        return None
    return 1e3 * total / len(reqs)
