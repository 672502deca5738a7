"""PyTorch port, independence: no file of ``scaletorch_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, directly or through a
relative import; and the package imports without either loaded. No file
imports ``safetensors``, ``transformers`` or ``datasets`` at module level,
and every module imports with the three blocked."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "scaletorch_tpu")


def port_files():
    files = sorted((ROOT / "scaletorch_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_the_scan_sees_the_port():
    names = {p.name for p in port_files()}
    assert {"engine.py", "paged_attention.py", "chip_smoke.py",
            "pipeline_parallel.py", "quantized_collectives.py",
            "expert_parallel.py"} <= names


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_package_imports_without_jax():
    # modules loaded before the import (a site hook may preload some)
    # are not the port's doing
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import scaletorch_tpu_torch.inference, scaletorch_tpu_torch.models\n"
        "import scaletorch_tpu_torch.ops.paged_attention, chip_smoke\n"
        "bad = [m for m in set(sys.modules) - before "
        f"if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# The card's machine has none of these: the port may import them only
# inside a function that needs them (a tokenizer given by name).
ABSENT_ON_THE_CARD = ("safetensors", "transformers", "datasets")


def module_level_imports(path: Path):
    """Top-level names imported outside any function body."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0]
            elif (isinstance(child, ast.ImportFrom) and child.level == 0
                  and child.module):
                yield child.module.split(".")[0]
            yield from walk(child)

    return set(walk(tree))


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_imports_absent_on_the_card(path):
    bad = module_level_imports(path) & set(ABSENT_ON_THE_CARD)
    assert not bad, f"{path.name} imports {sorted(bad)} at module level"


def test_every_module_imports_with_those_packages_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "scaletorch_tpu_torch").rglob("*.py"))
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = (
        "import importlib, sys\n"
        f"for name in {ABSENT_ON_THE_CARD!r}:\n"
        "    sys.modules[name] = None  # any import of it fails\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from scaletorch_tpu_torch.data.dataset import DatasetProcessor\n"
        "try:\n"
        "    DatasetProcessor('some/tokenizer', 8)\n"
        "except ImportError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('a tokenizer by name needs transformers')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
