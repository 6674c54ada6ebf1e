"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program either: top-level module names
compared whole (``fal_net_torch`` is not ``fal_net_tpu``)."""

import ast
import os

import pytest

from portbench.harness import guard, spec

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.BENCH_DIR) for f in fs if f.endswith(".py"))


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax(path):
    assert not imported_tops(path) & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.basename(p))
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & {"fal_net_torch", *guard.FORBIDDEN}


def test_whole_name_comparison():
    src = "import fal_net_torch.models\nfrom fal_net_tpu_extra import x\nimport jaxlib.xla\n"
    tree_tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tree_tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tree_tops.add(node.module.split(".", 1)[0])
    assert tree_tops & set(guard.FORBIDDEN) == {"jaxlib"}
