"""The import walk: no file of the benchmark imports JAX or the JAX package,
and the plain reference imports nothing of the port either.  Names are
compared by their whole top-level part: the port's name begins with the
JAX package's."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mysticeti_tpu"}
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    """(top-level name, relative level) of every import in the file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield (node.module or "").split(".")[0], node.level
            else:
                yield node.module.split(".")[0], 0
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], 0


def test_the_walk_sees_every_file():
    names = {p.relative_to(HERE).as_posix() for p in FILES}
    assert {"run.py", "check.py", "reference/blocks.py", "reference/ed25519.py"} <= names
    assert any(n.startswith("layer_metrics/") for n in names)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_file_imports_jax_or_the_jax_package(path):
    found = {name for name, level in top_level_imports(path) if level == 0} & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_the_reference_imports_nothing_of_the_port(path):
    for name, level in top_level_imports(path):
        assert name != "mysticeti_tpu_torch" and name not in FORBIDDEN, (path, name)
        assert level <= 1, f"{path} reaches outside the reference"


def test_the_walk_would_catch_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom mysticeti_tpu.types import X\nimport mysticeti_tpu_torch\n")
    names = {n for n, _ in top_level_imports(bad)}
    assert names & FORBIDDEN == {"jax", "mysticeti_tpu"} and "mysticeti_tpu_torch" in names
