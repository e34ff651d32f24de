"""No module of the benchmark imports JAX, Flax or the JAX package; the
yardstick (reference, readers, trace reduction, content, roofline)
imports nothing of the port either: only the kinds call it. Top-level
module names are compared whole: ``video_super_resolution_tpu_torch``
begins with ``video_super_resolution_tpu``."""

import ast
import os
import subprocess
import sys

import pytest

from vsr_bench import run

BANNED = {"jax", "jaxlib", "flax", "video_super_resolution_tpu"}
PORT = "video_super_resolution_tpu_torch"
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(run.HERE)
               for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & BANNED


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "kinds" + os.sep
                                  not in p and os.sep + "tests" + os.sep not in p],
                         ids=lambda p: os.path.relpath(p, run.HERE))
def test_yardstick_imports_no_port(path):
    assert PORT not in set(top_level_imports(path))


def test_names_compare_whole():
    assert "video_super_resolution_tpu_torch".split(".")[0] not in BANNED
    assert run.BANNED == ("jax", "jaxlib", "flax", "video_super_resolution_tpu")


def test_a_run_imports_no_jax():
    """A cell's modules, the port's included, leave no banned name in
    sys.modules (a fresh process: the test session may hold JAX)."""
    code = ("import sys; from vsr_bench import run; spec = run.load_spec(later=True); "
            "[run.resolve(spec, w['name']) for w in spec['workloads']]; "
            "print(run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


HARNESS_WIDE = ["run.py", "sweep.py", "idle_split.py", "cell.py", "roofline.py",
                "trace.py", "weights.py", "calibrate.py", "readers.py",
                "spans.py", "content.py"]


def reference_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names
                        if a.name.startswith("vsr_bench.reference"))
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module.startswith("vsr_bench.reference")):
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("name", HARNESS_WIDE)
def test_harness_wide_modules_reach_the_reference_through_the_run(name):
    """Only the configuration names an architecture's reference: a module
    every cell runs imports none (``Run.reference`` is resolved by name)."""
    assert list(reference_imports(os.path.join(run.HERE, name))) == []
