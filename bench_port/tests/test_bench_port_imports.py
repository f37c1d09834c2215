"""What the benchmark runs imports neither JAX nor the JAX package, and
its reference imports nothing of the program: an AST walk over every
module that ``run.py`` (with every entry and metric it finds by name)
and ``reference/`` reach, comparing whole top-level names (the port's
name begins with the JAX package's)."""

from __future__ import annotations

import ast
import glob
import os

from bench_port import harness

ROOT = harness.ROOT
JAX = {"jax", "jaxlib", "flax", "raytracinginonesemester_tpu"}
LOCAL = ("bench_port", harness.PACKAGE)


def _file(module: str):
    base = os.path.join(ROOT, *module.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _module(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
    return ".".join(rel[:-1] if rel[-1] == "__init__" else rel)


def _imports(path: str) -> set:
    mod = _module(path)
    package = mod if path.endswith("__init__.py") else mod.rpartition(".")[0]
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                parts = parts[:len(parts) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            names.add(base)
            names.update(f"{base}.{a.name}" for a in node.names)
    return {n for n in names if n}


def closure(paths) -> set:
    """Every module name imported from ``paths``, following the repo's own
    modules."""
    seen, todo, names = set(), list(paths), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            names.add(name)
            if name.split(".")[0] in LOCAL:
                found = _file(name)
                if found:
                    todo.append(found)
    return names


def _top(names) -> set:
    return {n.split(".")[0] for n in names}


def _bench_modules():
    files = glob.glob(os.path.join(ROOT, "bench_port", "**", "*.py"),
                      recursive=True)
    return [f for f in files if os.sep + "tests" + os.sep not in f]


def test_nothing_the_benchmark_runs_imports_jax():
    names = closure(_bench_modules())
    assert not (_top(names) & JAX), sorted(n for n in names
                                           if n.split(".")[0] in JAX)
    assert harness.PACKAGE in _top(names)  # the walk did reach the port


def test_the_reference_imports_nothing_of_the_program():
    ref = glob.glob(os.path.join(ROOT, "bench_port", "reference", "*.py"))
    top = _top(closure(ref))
    assert not (top & (JAX | {harness.PACKAGE})), sorted(top)
    assert "torch" in top and "numpy" in top


def test_the_check_compares_whole_names():
    assert harness.PACKAGE.startswith("raytracinginonesemester_tpu")
    assert harness.PACKAGE.split(".")[0] not in JAX
    assert "raytracinginonesemester_tpu" in harness.FORBIDDEN
