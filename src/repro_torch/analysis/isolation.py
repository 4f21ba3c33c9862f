"""The port's firewall (RA401): no port file imports the reference.

The reference's RA401 keeps in-repo code off its deprecated shims; the
port dropped those shims, and its firewall is the rule that it stands
alone.  ``src/repro_torch/``, ``examples/*_torch.py`` and
``chip_smoke.py`` import neither ``jax`` nor ``jaxlib``, nor anything of
the reference package ``repro`` (not even its numpy-only modules: the
port keeps its own copies), nor ``ml_dtypes``.  This is the static twin
of ``tests/test_torch_isolation.py``: flagged are ``import M``,
``from M import n`` (absolute), and ``importlib.import_module("M")`` /
``__import__("M")`` with a literal name, for ``M`` one of those packages
or a submodule of one (``repro_torch`` is not ``repro``).
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Tuple

from repro_torch.analysis.base import Finding, Imports, SourceFile

FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def forbidden(module: str) -> bool:
    """``jax``, ``repro`` and their submodules — not ``repro_torch``."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(src: SourceFile, imports: Imports
             ) -> Iterator[Tuple[ast.AST, str]]:
    for node in src.nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = imports.resolve(node.func) or (
                node.func.id if isinstance(node.func, ast.Name) else "")
            if fn in ("importlib.import_module", "__import__"):
                yield node, node.args[0].value


class IsolationChecker:
    code_prefix = "RA4"
    name = "isolation"

    def check(self, src: SourceFile) -> List[Finding]:
        return [Finding(
            "RA401", src.path, node.lineno, node.col_offset,
            f"import of {module} — the port imports nothing of jax, "
            f"jaxlib, ml_dtypes or the reference package repro; keep "
            f"its own copy under repro_torch")
            for node, module in _imports(src, Imports(src.tree))
            if forbidden(module)]
