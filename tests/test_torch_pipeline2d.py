"""The 2D datagen pipeline's spans (``sim/pipeline.pipeline_2d``) on the
CPU, where the rollouts are the kernel's plain version, at a small pose
grid: a traced run opens one ``datagen.arrays`` span (inside the wave's
``pipeline.launch``) and one ``datagen.records`` span (inside its
``pipeline.drain``) a wave, and one ``scene.object`` span a pair; once the
block's fingers are cached, no jaw mass is built. That the pipeline's
records are its rollouts, bit for bit, is ``test_torch_datagen.py``'s."""

import pytest

from dgdm_tpu_torch.core.profiling import TRACER
from dgdm_tpu_torch.geom.contour import extract_contours, synthetic_icon
from dgdm_tpu_torch.sim import pipeline
from tests import torch_parity  # noqa: F401  (one torch thread)

GRID = dict(grid_size=4, num_pos=1)


@pytest.fixture
def tracer():
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()
        TRACER.start()
        TRACER.stop()


def _records(objects, grippers):
    got = {}
    summary = pipeline.pipeline_2d(
        objects, grippers, device="cpu",
        on_records=lambda oi, recs: got.__setitem__(oi, recs), **GRID)
    return summary, got


def test_traced_waves_open_one_span_of_each_and_a_scene_a_pair(tracer):
    objects = [(oi, extract_contours(synthetic_icon(oi))) for oi in (0, 1)]
    grippers = list(range(100, 104))
    _records(objects[:1], grippers)             # fills the finger cache
    tracer.start()
    summary, got = _records(objects, grippers)
    spans = tracer.stop()
    waves = summary["waves"]
    assert waves == 2 and len(got[1]) == len(grippers)
    names = [s[0] for s in spans]
    assert names.count("datagen.arrays") == waves
    assert names.count("datagen.records") == waves
    assert names.count("scene.object") == waves * len(grippers)
    assert not [n for n in names if n.startswith("scene.jaw_mass.")]
    for inner, outer in (("datagen.arrays", "pipeline.launch"),
                         ("datagen.records", "pipeline.drain")):
        outers = [s for s in spans if s[0] == outer]
        for s in spans:
            if s[0] == inner:
                assert sum(o[1] <= s[1] and s[2] <= o[2]
                           for o in outers) == 1, inner
