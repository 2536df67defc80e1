"""Nothing the benchmark runs imports the JAX stack or the JAX package
(top-level names compared whole: ``ich_tpu_torch`` is not ``ich_tpu``),
the plain reference imports nothing of the program, and the drivers and
nets import it only inside their functions."""

import ast
import sys

import pytest

from portbench.common.manifest import PKG
from portbench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_the_jax_stack(path):
    tops = {m.partition(".")[0] for m in imported(path)}
    assert not tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    mods = list(imported(path))
    assert not {m.partition(".")[0] for m in mods} & {"ich_tpu_torch", "ich_tpu"}
    assert all(m == "portbench.reference" or m.startswith("portbench.reference.")
               for m in mods if m.startswith("portbench"))


def test_the_run_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ich_tpu_torchx", sys)
    assert "ich_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "ich_tpu.fake", sys)
    assert "ich_tpu" in forbidden_modules()


@pytest.mark.parametrize("path", sorted((PKG / "drivers").glob("*.py")) + sorted(
    (PKG / "nets").glob("*.py")), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_drivers_and_nets_import_the_program_when_called(path):
    top = ast.parse(path.read_text()).body
    mods = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in top if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not {m.partition(".")[0] for m in mods} & {"ich_tpu_torch", "ich_tpu"}
