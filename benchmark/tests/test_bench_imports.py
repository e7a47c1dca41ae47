"""What a chip run loads: nothing of JAX or the JAX package (top-level
module names compared whole, so ``cat_tpu_torch`` is allowed and
``cat_tpu`` is not), and the plain references nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "cat_tpu"}

_RUN_TINY = """
import sys, tempfile, importlib, glob, os
from benchmark import run, control
from benchmark.tests.tiny import make_root
d = tempfile.mkdtemp()

r = run.run(["--workload", make_root(d), "--seed", "7", "--seconds", "0.3", "--trace", "1"],
            device_override="cpu", root=d)
for f in glob.glob(os.path.join(os.path.dirname(run.__file__), "metrics", "*.py")):
    importlib.import_module("benchmark.metrics." + os.path.basename(f)[:-3])
for f in glob.glob(os.path.join(os.path.dirname(run.__file__), "families", "*.py")):
    importlib.import_module("benchmark.families." + os.path.basename(f)[:-3])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _modules(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _modules(_RUN_TINY)
    assert "cat_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_forbidden_names_compare_whole_top_level():
    from benchmark import run

    saved = dict(sys.modules)
    try:
        sys.modules["cat_tpu_torch_fake"] = sys
        sys.modules["cat_tpu.x"] = sys
        assert run.forbidden_modules() == ["cat_tpu.x"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_references_import_nothing_of_the_program():
    refs = glob.glob(os.path.join(REPO, "benchmark", "reference", "*.py"))
    assert refs
    seen, todo = set(), list(refs)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"cat_tpu_torch"}, (path, name)
            if top == "benchmark":
                mod = os.path.join(REPO, *name.split(".")) + ".py"
                if os.path.exists(mod):
                    todo.append(mod)
    loaded = _modules("import sys; import benchmark.reference.inception_ka; "
                      "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert not loaded & (FORBIDDEN | {"cat_tpu_torch"})
