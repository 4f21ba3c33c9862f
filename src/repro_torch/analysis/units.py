"""Units lint (RA301/RA302): suffix-driven dimensional analysis over
the port's wire and cost-model modules.

A copy of the reference's checker, rule for rule, so that the port's
gate finds on ``src/repro_torch/core/{cost_model,wire,pipeline}.py`` and
``src/repro_torch/distrib/tiered_sync.py`` exactly what the reference
finds on its own four (the tests hold the two equal).  A byte count that
flows into arithmetic that assumes element counts silently moves every
optimal cut; the identifiers carry their units as suffixes
(``act_bytes``, ``resolved_grad_elems``, ``uplink_mbps``) and this
checker makes those suffixes load-bearing.

Unit families (suffix match on the last identifier segment, or the
bare word): ``bytes``, ``elems``, ``mb``/``kb``/``gb``, ``mbps``.
Rules, deliberately conservative (unknown never flags):

* **RA301** — ``+``, ``-``, ``*`` or a comparison whose two operands
  have *known, different* families mixes units.  Division is the
  canonical conversion (``x_mb / bw_mbps`` is seconds, ``bytes / 4``
  is elements) and never flags; its result is unknown.  A function
  call is a conversion boundary: its result takes the unit of the
  *callee's* suffix (``int8_wire_bytes(...)`` is bytes), never its
  arguments'.
* **RA302** — a value of one family bound to a name of another:
  assignment targets, keyword arguments, positional arguments matched
  against same-module parameter names, and ``return`` against the
  enclosing function's name suffix (``f(act_elems=x_bytes)`` is caught
  at the call site).

Identifiers containing ``_per_`` are rates and read as unknown.  The
intended escape hatch at a real conversion point (int8: one byte per
element) is an inline ``# repro-lint: disable=RA301 <why>``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.base import Finding, SourceFile, walk_functions

# suffix -> family.  mb/kb/gb are one family (decimal data sizes) but
# distinct from raw bytes: mixing them without a conversion is exactly
# the 1e6-factor bug class.
_FAMILY = {
    "bytes": "bytes",
    "elems": "elems",
    "mb": "mb", "kb": "mb", "gb": "mb",
    "mbps": "mbps",
}


def unit_of_name(identifier: str) -> Optional[str]:
    """Unit family of an identifier, by suffix (``act_bytes``) or bare
    word (``elems``).  ``_per_`` names are rates: unknown."""
    low = identifier.lower()
    if "_per_" in low:
        return None
    for suffix, family in _FAMILY.items():
        if low == suffix or low.endswith("_" + suffix):
            return family
    return None


class _Units(ast.NodeVisitor):
    def __init__(self, src: SourceFile, param_units: Dict[str, Dict]):
        self.src = src
        self.param_units = param_units     # fn name -> pos -> family
        self.findings: List[Finding] = []
        self._fn_stack: List[str] = []

    # -- expression unit inference --------------------------------------
    def unit(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Name):
            return unit_of_name(node.id)
        if isinstance(node, ast.Attribute):
            return unit_of_name(node.attr)
        if isinstance(node, ast.Call):
            # conversion boundary: result unit = callee suffix
            f = node.func
            callee = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else None)
            return unit_of_name(callee) if callee else None
        if isinstance(node, ast.BinOp):
            lu, ru = self.unit(node.left), self.unit(node.right)
            if isinstance(node.op, (ast.Add, ast.Sub)):
                return lu or ru
            if isinstance(node.op, ast.Mult):
                # rate * count converts (bytes_per_elem * elems is
                # bytes, not elems): result unknown, never flagged.
                if self._is_rate(node.left) or self._is_rate(node.right):
                    return None
                # unit * dimensionless keeps the unit
                if lu and ru is None:
                    return lu
                if ru and lu is None:
                    return ru
                return None
            return None                     # division etc.: converted
        if isinstance(node, ast.UnaryOp):
            return self.unit(node.operand)
        if isinstance(node, ast.IfExp):
            return self.unit(node.body) or self.unit(node.orelse)
        return None

    @staticmethod
    def _is_rate(node: ast.AST) -> bool:
        ident = None
        if isinstance(node, ast.Name):
            ident = node.id
        elif isinstance(node, ast.Attribute):
            ident = node.attr
        return bool(ident) and "_per_" in ident.lower()

    def _flag_mix(self, node: ast.AST, lu: str, ru: str,
                  what: str) -> None:
        self.findings.append(Finding(
            "RA301", self.src.path, node.lineno, node.col_offset,
            f"{what} mixes unit families {lu!r} and {ru!r} without an "
            f"explicit conversion — route one side through a "
            f"conversion call or divide by the unit factor"))

    # -- RA301 -----------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Mod)):
            lu, ru = self.unit(node.left), self.unit(node.right)
            if lu and ru and lu != ru:
                op = type(node.op).__name__.lower()
                self._flag_mix(node, lu, ru, f"'{op}' arithmetic")
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        lu = self.unit(node.left)
        for comp in node.comparators:
            ru = self.unit(comp)
            if lu and ru and lu != ru:
                self._flag_mix(node, lu, ru, "comparison")
        self.generic_visit(node)

    # -- RA302 -----------------------------------------------------------
    def visit_Assign(self, node: ast.Assign) -> None:
        vu = self.unit(node.value)
        if vu:
            for t in node.targets:
                tu = None
                if isinstance(t, ast.Name):
                    tu = unit_of_name(t.id)
                elif isinstance(t, ast.Attribute):
                    tu = unit_of_name(t.attr)
                if tu and tu != vu:
                    self.findings.append(Finding(
                        "RA302", self.src.path, node.lineno,
                        node.col_offset,
                        f"a {vu!r} value is assigned to "
                        f"{self._tname(t)!r} ({tu}) — convert "
                        f"explicitly or rename"))
        self.generic_visit(node)

    @staticmethod
    def _tname(t: ast.AST) -> str:
        if isinstance(t, ast.Name):
            return t.id
        if isinstance(t, ast.Attribute):
            return t.attr
        return "<target>"

    def visit_Call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if kw.arg is None:
                continue
            tu = unit_of_name(kw.arg)
            vu = self.unit(kw.value)
            if tu and vu and tu != vu:
                self.findings.append(Finding(
                    "RA302", self.src.path, kw.value.lineno,
                    kw.value.col_offset,
                    f"a {vu!r} value is passed for keyword "
                    f"{kw.arg!r} ({tu}) — the callee expects {tu}, "
                    f"convert at the call site"))
        # positional args against same-module parameter names
        f = node.func
        fname = f.id if isinstance(f, ast.Name) else None
        pmap = self.param_units.get(fname or "", {})
        for i, arg in enumerate(node.args):
            tu = pmap.get(i)
            vu = self.unit(arg)
            if tu and vu and tu != vu:
                self.findings.append(Finding(
                    "RA302", self.src.path, arg.lineno, arg.col_offset,
                    f"a {vu!r} value is passed to parameter "
                    f"{pmap.get(('name', i), i)!r} ({tu}) of "
                    f"{fname}() — convert at the call site"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is not None and self._fn_stack:
            fu = unit_of_name(self._fn_stack[-1])
            vu = self.unit(node.value)
            if fu and vu and fu != vu:
                self.findings.append(Finding(
                    "RA302", self.src.path, node.lineno, node.col_offset,
                    f"{self._fn_stack[-1]}() is named as {fu!r} but "
                    f"returns a {vu!r} value — convert before "
                    f"returning"))
        self.generic_visit(node)


class UnitsChecker:
    code_prefix = "RA3"
    name = "units"

    def check(self, src: SourceFile) -> List[Finding]:
        # parameter units of same-module functions, for positional RA302
        param_units: Dict[str, Dict] = {}
        for fn in walk_functions(src.tree):
            args = fn.args.posonlyargs + fn.args.args
            pmap: Dict = {}
            for i, a in enumerate(args):
                u = unit_of_name(a.arg)
                if u:
                    pmap[i] = u
                    pmap[("name", i)] = a.arg
            if pmap:
                param_units.setdefault(fn.name, pmap)
        v = _Units(src, param_units)
        v.visit(src.tree)
        return v.findings
