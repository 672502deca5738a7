"""PyTorch port, independence: no file of ``scaletorch_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, directly or through a
relative import; and the package imports without either loaded."""

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
    assert {"engine.py", "paged_attention.py", "chip_smoke.py"} <= names


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
