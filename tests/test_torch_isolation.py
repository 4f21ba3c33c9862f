"""The port stands alone: ``src/repro_torch/`` and ``chip_smoke.py``
import neither ``jax`` nor anything of the ``repro`` package (not even
its numpy-only modules — the port keeps its own copies)."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(module: str) -> bool:
    """``jax``, ``repro`` and their submodules — but not ``repro_torch``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
            if node.module is None:
                continue
            # ``from repro import api`` imports repro.api
            for alias in node.names:
                yield node.lineno, f"{node.module}.{alias.name}"


def test_guard_tells_repro_from_repro_torch():
    assert _forbidden("repro") and _forbidden("repro.core.lp")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("repro_torch") and not _forbidden("repro_torch.api")
    assert not _forbidden("jaxtyping") and not _forbidden("reprox")


def test_port_has_files_to_scan():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/api.py" in names
    assert "src/repro_torch/core/hybrid_step.py" in names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if _forbidden(mod)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax_or_repro():
    code = (
        "import sys\n"
        "import repro_torch.api, repro_torch.core.hybrid_step\n"
        "import repro_torch.kernels.ops, repro_torch.convert\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'repro') or m.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
