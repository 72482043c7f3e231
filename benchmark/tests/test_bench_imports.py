"""What the benchmark's modules import, by top-level name compared whole:
nothing of JAX or the JAX package anywhere under ``benchmark/``, and nothing
of the port in the plain references. And the entry's refusal without a card."""
import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "refil_tpu"}


def _modules():
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            names.add(".")  # relative: inside the benchmark
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                         if os.sep + "references" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_the_references_import_torch_alone(path):
    assert _top_level_imports(path) <= {"__future__", "math", "typing", "torch"}


def test_no_result_without_a_card():
    """On a machine without a card the entry exits non-zero and prints no
    result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "refil_sz.b8",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "refil_sz.b8",
                           "--seed", "2147483659", "--seconds", "0", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert '"correct": true' in proc.stdout.strip().splitlines()[-1]
