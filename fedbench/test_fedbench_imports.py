"""Nothing that the benchmark runs loads JAX or the JAX package ``repro``;
top-level module names are compared whole (``repro_torch`` is not
``repro``)."""
import ast
import json
import os
import subprocess
import sys

from fedbench.run import FORBIDDEN
from fedbench.testing import HERE, ROOT

PROBE = r"""
import importlib, json, pkgutil, sys, tempfile, time
from pathlib import Path
import fedbench
for m in pkgutil.walk_packages(fedbench.__path__, "fedbench."):
    if not m.name.split(".")[-1].startswith("test_"):
        importlib.import_module(m.name)
from fedbench import control, run
from fedbench.discover import load_cell
from fedbench.testing import tiny_root
root = tiny_root(Path(tempfile.mkdtemp()))
for w in ("tiny.fedpsa", "tiny.fedasync", "tiny.fedpsa.sweep3"):
    run.run(load_cell(root, w), 3, 0.05, w == "tiny.fedpsa", "cpu",
            t_start=time.perf_counter())
control.cases(load_cell(root, "tiny.fedasync"), 4, "cpu")
print(json.dumps(run.forbidden_modules()))
"""


def test_rehearsal_loads_no_jax():
    """In a process of its own (other test files import JAX): import every
    module of the benchmark, rehearse its cells on the CPU, then look."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def _imports(path):
    """Every module a file imports, by its full name."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    """The reference reads only the benchmark's inputs: nothing of
    ``repro_torch``, nor the harness code that runs it."""
    for path in (HERE / "reference").rglob("*.py"):
        for m in _imports(path):
            assert m.split(".")[0] != "repro_torch", (path, m)
            assert m not in ("fedbench.program", "fedbench.faults",
                             "fedbench.run", "fedbench.control"), (path, m)
