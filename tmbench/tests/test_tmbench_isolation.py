"""Nothing the benchmark runs imports JAX or the reference package ``repro``,
and the plain reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

from tmbench import isolation  # noqa: E402

BENCH = os.path.join(ROOT, "tmbench")


@pytest.mark.parametrize("name, bad", [
    ("repro_torch", False), ("repro_torch.kernels.ops", False), ("reproduce", False),
    ("jax_like", False), ("torch", False),
    ("repro", True), ("repro.kernels", True), ("jax", True), ("jax.numpy", True),
    ("jaxlib.xla_client", True), ("flax.linen", True),
])
def test_top_level_names_are_compared_whole(name, bad):
    assert isolation.forbidden([name]) == ([name] if bad else [])


def imported(path):
    """Top-level module names a file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def run_time_files():
    """The files a run executes: the entry, the yardstick, kinds, metrics,
    the reference and the controls (not the tests, not the asset recipe)."""
    files = glob.glob(os.path.join(BENCH, "*.py"))
    for sub in ("kinds", "metrics", "reference"):
        files += glob.glob(os.path.join(BENCH, sub, "*.py"))
    return sorted(files)


def test_no_run_time_file_imports_jax_or_the_reference_package():
    for path in run_time_files():
        assert not isolation.forbidden(imported(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert imported(path) <= {"__future__", "numpy", "torch"}, path


def test_a_run_loads_no_forbidden_module():
    """A fresh process that imports what a run imports holds no module of
    JAX or of the reference package."""
    code = (
        "import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
        "import tmbench.run, tmbench.controls\n"
        "from tmbench import isolation, manifest\n"
        "for k in ('infer_stream', 'train_stream'): manifest.kind(k)\n"
        "for m in manifest.load()['end_to_end'] + manifest.load()['per_layer']:\n"
        "    manifest.reader(m['name'])\n"
        "import repro_torch.core.compiler, repro_torch.kernels.ops, repro_torch.core.tm\n"
        "print(isolation.forbidden_modules())\n"
    ).format(root=ROOT, src=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
