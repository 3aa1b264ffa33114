"""Nothing the benchmark runs imports JAX or the JAX package: a walk over
the syntax trees of every module that ``perfbench/run.py`` reaches (the
traffic runners and metric readers it loads by name included, and imports
inside functions too), comparing each imported module's top-level name
whole (the port's ``dgdm_tpu_torch`` is not ``dgdm_tpu``); the reference
imports nothing of the program either."""

import ast
import glob
import os

from perfbench import harness

ROOT = harness.ROOT
OURS = ("perfbench", "dgdm_tpu_torch")


def _file_of(module: str):
    base = os.path.join(ROOT, *module.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _module_of(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _imports(path: str):
    """Every module name imported anywhere in ``path`` (for ``from a
    import b`` both ``a`` and ``a.b``)."""
    pkg = _module_of(path)
    if not path.endswith("__init__.py"):
        pkg = pkg.rpartition(".")[0]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                base = ".".join(parts[:len(parts) - node.level + 1])
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"


def reached(roots):
    """(files walked, every module name they import)."""
    todo, seen, names = list(roots), set(), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            names.add(name)
            if name.split(".")[0] in OURS:
                f = _file_of(name)
                if f is not None:
                    todo.append(f)
    return seen, names


def _roots():
    here = os.path.join(ROOT, "perfbench")
    return ([os.path.join(here, "run.py")]
            + glob.glob(os.path.join(here, "traffic", "*.py"))
            + glob.glob(os.path.join(here, "metrics", "*.py")))


def test_nothing_reached_imports_jax_or_the_jax_package():
    files, names = reached(_roots())
    assert any(f.endswith(os.path.join("sim", "rollout2d.py"))
               for f in files), "the walk did not reach the program"
    bad = sorted(n for n in names if n.split(".")[0] in harness.FORBIDDEN)
    assert bad == []


def test_the_reference_imports_nothing_of_the_program():
    roots = glob.glob(os.path.join(ROOT, "perfbench", "reference", "*.py"))
    _, names = reached(roots)
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("dgdm_tpu_torch",)
                 + harness.FORBIDDEN)
    assert bad == []


def test_the_run_time_check_compares_whole_top_level_names():
    loaded = ["dgdm_tpu_torch", "dgdm_tpu_torch.sim.rollout2d", "numpy",
              "jaxtyping", "flaxen", "dgdm_tpu", "dgdm_tpu.sim",
              "jax.numpy", "jaxlib", "flax.linen", "optax",
              "orbax.checkpoint"]
    assert harness.forbidden_modules(loaded) == sorted(
        ["dgdm_tpu", "dgdm_tpu.sim", "jax.numpy", "jaxlib", "flax.linen",
         "optax", "orbax.checkpoint"])
