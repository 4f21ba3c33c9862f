"""The port stands alone: ``src/repro_torch/``, its examples
(``examples/*_torch.py``) and ``chip_smoke.py`` import neither ``jax``
nor anything of the ``repro`` package (not even its numpy-only modules
— the port keeps its own copies), nor ``ml_dtypes`` (bf16 crosses the
package boundary as raw bits)."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


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
    assert "src/repro_torch/models/lm/layerstack.py" in names
    assert "src/repro_torch/train/loop.py" in names
    assert "src/repro_torch/checkpoint/store.py" in names
    assert "src/repro_torch/data/pipeline.py" in names
    assert "src/repro_torch/core/churn.py" in names
    assert "src/repro_torch/core/simulator.py" in names
    assert "src/repro_torch/serve/planner.py" in names
    assert "src/repro_torch/serve/engine.py" in names
    assert "src/repro_torch/configs/base.py" in names
    assert "src/repro_torch/models/lm/model.py" in names
    assert "examples/serve_lm_torch.py" in names
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
        "import repro_torch.models.lm.layerstack\n"
        "import repro_torch.configs.zamba2_7b\n"
        "import repro_torch.models.lm.fleet_configs\n"
        "import repro_torch.train.loop, repro_torch.checkpoint.store\n"
        "import repro_torch.data.pipeline, repro_torch.core.churn\n"
        "import repro_torch.core.profiler, repro_torch.core.simulator\n"
        "import repro_torch.core.baselines, repro_torch.serve.planner\n"
        "import repro_torch.serve.population, repro_torch.serve.engine\n"
        "import repro_torch.configs, repro_torch.models.lm.model\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
        "'repro', 'ml_dtypes') or m.startswith(('jax.', 'jaxlib.', "
        "'repro.', 'ml_dtypes.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
