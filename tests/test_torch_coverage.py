"""Name-by-name coverage of the JAX package by the port.

Every top-level public name (function, class or assigned constant, read
from the source by ``ast``) of every ``dgdm_tpu/**.py`` must exist in the
module of the same path under ``dgdm_tpu_torch/`` (defined there or
imported into it), or stand in ``COUNTERPARTS`` below, which gives each
such name its port counterpart under another name or path, or the reason
it has none. A name added to the JAX package with neither fails the test;
so does an entry of ``COUNTERPARTS`` whose counterpart is missing, or
which no longer names a gap."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "dgdm_tpu", ROOT / "dgdm_tpu_torch"

_ORACLE = ("the MuJoCo oracle imports no JAX and lies on no path of the "
           "port; the port's tests call the JAX package's module directly")
_ANCHOR = ("the rejected ear-clip anchor experiment (non-uniform "
           "triangulation, upsampled contours); no path of the port calls it")
_GEOMKIT = ("native/geomkit.cpp's bindings serve the MuJoCo oracle and the "
            "rejected anchor experiment; no path of the port calls them")
_PALLAS2D = "K1's launcher and its plain version"
_PALLAS3D = "K2's launcher and its plain version"

# (JAX module, name) -> (port module, name, why) where the counterpart has
# another name or path; (None, None, why) where there is none
COUNTERPARTS = {
    ("core/profiling.py", "annotate"): (
        "core/profiling.py", "TRACER",
        "the program's named regions are the recorder's host spans"),
    ("core/profiling.py", "trace"): (
        "core/profiling.py", "TraceWindow",
        "a bounded torch.profiler window over a loop's steps"),
    ("geom/native.py", "available"): (None, None, _GEOMKIT),
    ("geom/native.py", "build"): (None, None, _GEOMKIT),
    ("geom/native.py", "ear_clip"): (None, None, _GEOMKIT),
    ("geom/native.py", "points_in_polygon"): (None, None, _GEOMKIT),
    ("geom/native.py", "resample_contour"): (None, None, _GEOMKIT),
    ("geom/native.py", "trace_largest_contour"): (None, None, _GEOMKIT),
    ("geom/polygon.py", "dedupe_polygon"): (None, None, _ANCHOR),
    ("geom/polygon.py", "ear_clip"): (None, None, _ANCHOR),
    ("geom/polygon.py", "earclip_anchor_weights"): (None, None, _ANCHOR),
    ("models/unet1d.py", "Downsample1d"): (
        "models/unet1d.py", "ConditionalUnet1D",
        "a plain strided nn.Conv1d inside the UNet"),
    ("models/unet1d.py", "Upsample1d"): (
        "models/unet1d.py", "ConditionalUnet1D",
        "a plain nn.ConvTranspose1d inside the UNet"),
    ("sim/oracle.py", "Oracle2D"): (None, None, _ORACLE),
    ("sim/oracle.py", "build_scene_xml_2d"): (None, None, _ORACLE),
    ("sim/oracle3d.py", "Oracle3D"): (None, None, _ORACLE),
    ("sim/oracle3d.py", "build_scene_xml_3d"): (None, None, _ORACLE),
    ("sim/engine2d.py", "upsample_contour"): (None, None, _ANCHOR),
    ("sim/pallas2d.py", "EPS_SETTLED"): (
        "sim/rollout2d_ref.py", "EPS_SETTLED", _PALLAS2D),
    ("sim/pallas2d.py", "LANE"): ("sim/rollout2d_ref.py", "LANE", _PALLAS2D),
    ("sim/pallas2d.py", "NEWTON_KERNEL_ITERS"): (
        "sim/engine2d.py", "NEWTON_ITERS",
        "K1 and the pure engine share the count, 3"),
    ("sim/pallas2d.py", "profile_batch_pallas"): (
        "sim/rollout2d.py", "profile_batch", _PALLAS2D),
    ("sim/pallas2d.py", "scene_arrays"): (
        "sim/rollout2d.py", "scene_arrays", _PALLAS2D),
    ("sim/pallas3d.py", "EPS_SETTLED"): (
        "sim/rollout3d_ref.py", "EPS_SETTLED", _PALLAS3D),
    ("sim/pallas3d.py", "LANE"): ("sim/rollout3d_ref.py", "LANE", _PALLAS3D),
    ("sim/pallas3d.py", "NEWTON_KERNEL_ITERS3"): (
        "sim/rollout3d.py", "NEWTON_KERNEL_ITERS3", _PALLAS3D),
    ("sim/pallas3d.py", "profile_batch_pallas3d"): (
        "sim/rollout3d.py", "profile_batch", _PALLAS3D),
    ("sim/pallas3d.py", "scene_arrays_3d"): (
        "sim/rollout3d.py", "scene_arrays_3d", _PALLAS3D),
    ("train/dynamics.py", "DynTrainState"): (
        "train/dynamics.py", "DynamicsTrainer",
        "the trainer holds the model, optimiser and step itself"),
    ("train/generator.py", "GenTrainState"): (
        "train/generator.py", "GeneratorTrainer",
        "the trainer holds the model, EMA copy, optimiser and step itself"),
}


def public_names(source: str, with_imports: bool = False) -> set:
    """Top-level public names a module's source defines (functions,
    classes, assignment targets) and, with ``with_imports``, imports."""
    names = set()
    for node in ast.parse(source).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(n.id for t in targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def gaps(jax_source: str, port_source) -> set:
    """Public names of a JAX module that the port's module (its source, or
    None where there is no such module) neither defines nor imports."""
    have = public_names(port_source, True) if port_source is not None \
        else set()
    return public_names(jax_source) - have


def _source(path: pathlib.Path):
    return path.read_text() if path.exists() else None


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    missing = gaps((JAX_PKG / module).read_text(),
                   _source(PORT_PKG / module))
    unmapped = sorted(n for n in missing if (module, n) not in COUNTERPARTS)
    assert unmapped == [], (
        f"dgdm_tpu/{module}: {unmapped} have no counterpart in "
        f"dgdm_tpu_torch/{module} and no entry in COUNTERPARTS")


@pytest.mark.parametrize("key", sorted(COUNTERPARTS),
                         ids=lambda k: f"{k[0]}:{k[1]}")
def test_mapped_counterpart_exists(key):
    module, name = key
    port_module, port_name, why = COUNTERPARTS[key]
    assert why
    # the entry still names a gap: the JAX name exists and the port's
    # module of the same path does not carry it
    assert name in gaps((JAX_PKG / module).read_text(),
                        _source(PORT_PKG / module)), key
    if port_module is not None:
        src = _source(PORT_PKG / port_module)
        assert src is not None and port_name in public_names(src, True), (
            f"{key}: dgdm_tpu_torch/{port_module}:{port_name} is missing")


def test_gaps_sees_a_missing_name():
    """The checker itself: a name the port lacks is a gap, a name it
    imports is not, private names are ignored, and a missing module lacks
    every name."""
    jax_src = ("import jax\nLANE = 128\ndef f(x): pass\nclass C: pass\n"
               "def _private(): pass\nA, (B, D) = 1, (2, 3)\n")
    port_src = "from x import f\nLANE: int = 128\nA = B = 0\n"
    assert gaps(jax_src, port_src) == {"C", "D"}
    assert gaps(jax_src, None) == {"LANE", "f", "C", "A", "B", "D"}
