"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gencore_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_harness_and_program_load_no_jax():
    code = (
        "import sys; sys.argv = ['run.py']\n"
        f"sys.path.insert(0, {BENCH!r})\n"
        "import run\n"
        "from harness import cells\n"
        f"spec = cells.load_spec({ROOT!r})\n"
        "for m in spec['per_layer']: cells.load_metric(run.BENCH, m['name'])\n"
        "run.load_program('cpu')\n"
        "import reference.run, reference.partition\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "gencore_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert not names & (FORBIDDEN | {"gencore_tpu_torch", "torch"}), (f, names)


def test_harness_sources_import_no_jax():
    for d in ("harness", "metrics", "reference"):
        for f in os.listdir(os.path.join(BENCH, d)):
            if f.endswith(".py"):
                assert not set(_imports(os.path.join(BENCH, d, f))) & FORBIDDEN, f
    assert not set(_imports(os.path.join(BENCH, "run.py"))) & FORBIDDEN
