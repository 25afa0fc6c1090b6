"""Nothing the benchmark runs loads JAX or the JAX package: every module
under bench/ is read for its imports, each compared by its whole
top-level name (repro_torch is not repro). Only the driving code imports
the program, and the plain reference imports none of it."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_the_program_only_where_driven(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = path.relative_to(BENCH).parts
    if "repro_torch" in names:
        assert rel[0] in ("harness", "tests"), rel
    if rel[0] == "reference":
        assert all(not n.startswith("repro") for n in names), names


def test_the_whole_name_is_compared():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.comms".split(".")[0] in FORBIDDEN


def test_reference_takes_only_the_reference():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("bench"):
                assert node.module.startswith("bench.reference"), path
