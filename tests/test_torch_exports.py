"""Port: every name a reference package exports imports from its port
counterpart.

The names are read from the reference's ``__init__.py`` source (its
``from ... import`` lines and the names its module ``__getattr__`` serves
lazily), so a name the reference adds is asked of the port too.
"""

import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("core", "data", "baselines", "runtime", "kernels", "checkpoint")


def _exported(package: str) -> set:
    path = os.path.join(REPO, "src", "repro", package, "__init__.py")
    tree = ast.parse(open(path).read())
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom) for a in node.names}
    for node in tree.body:        # lazy names: `if name in ("A", "B"):`
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Compare) and isinstance(sub.comparators[0], ast.Tuple):
                    names |= {e.value for e in sub.comparators[0].elts}
    return names


@pytest.mark.parametrize("package", PACKAGES)
def test_reference_package_names_import_from_the_port(package):
    names = _exported(package)
    port = importlib.import_module(f"repro_torch.{package}")
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, f"repro_torch.{package} lacks {missing}"


def test_lazy_engine_names_are_the_kernel_layers():
    from repro_torch import core
    from repro_torch.core import compiler
    from repro_torch.kernels import ops

    assert _exported("core") >= {"EngineSpec", "ENGINE_NAMES", "train_step", "fit"}
    assert core.EngineSpec is compiler.EngineSpec is ops.EngineSpec
    assert core.ENGINE_NAMES == ops.ENGINE_NAMES
    with pytest.raises(AttributeError):
        core.no_such_name
