"""Rebuild, cache and determinism hygiene (RA101–RA105).

The port's counterpart of the reference's ``jit_hygiene.py``.  Eager
PyTorch traces nothing, so each check is re-aimed at what costs or breaks
the same way here:

* **RA101 / RA102 — rebuilt every pass.**  ``torch.compile``,
  ``torch.jit.script`` / ``trace``, a CUDA graph capture
  (``torch.cuda.CUDAGraph()``, ``torch.cuda.graph``) and a library load
  (``ctypes.CDLL``, ``_build.library``) inside a loop body (RA101) build
  a new compiled graph, captured graph or loaded library each iteration;
  ``torch.compile(f)(x)`` called at once inside a function (RA102)
  rebuilds it on every call of that function.

* **RA103 — unbounded id()-keyed caches**, as the reference: a plain
  dict stored into under a key that calls ``id(...)`` grows without bound
  and aliases a dead entry once the id is recycled.  The port's bounded
  caches (``serve.engine._StepCache``) store through methods and never
  match.

* **RA104 — draws from a global generator** (:class:`GlobalRngChecker`,
  run on ``src/repro_torch/`` only).  The port's runs replay and resume
  bitwise from seeded generators; a draw from torch's, ``random``'s or
  numpy's global generator depends on whatever ran before it.  Flagged:
  ``torch.rand``/``randn``/``randint``/``randperm``/``bernoulli``/
  ``multinomial``/``normal``/``poisson`` (and ``*_like``), the in-place
  ``Tensor.uniform_``/``normal_``/``bernoulli_``/``random_``/
  ``exponential_`` without a ``generator=`` keyword (or with
  ``generator=None``), any dropout call (it takes no generator), any call
  of the stdlib ``random`` module but ``random.Random(seed)``, and legacy
  ``np.random.<fn>``; ``np.random.default_rng``, ``Generator``, the bit
  generators, ``SeedSequence`` and ``RandomState`` build a seeded
  generator of their own and pass.  Keywords are read from the call, not
  from its line: a ``generator=`` on a continuation line counts.

* **RA105 — unhashable cache arguments.**  A list, dict or set literal
  (or comprehension) passed to a function of the same module wrapped in
  ``functools.cache`` / ``lru_cache`` raises ``TypeError`` when called:
  the cache hashes its arguments.
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from repro_torch.analysis.base import (Finding, Imports, SourceFile,
                                       call_path, dotted_name,
                                       enclosing_loops, walk_functions)

_COMPILE_PATHS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
_REBUILD_PATHS = _COMPILE_PATHS | {
    "torch.cuda.CUDAGraph", "torch.cuda.graph", "ctypes.CDLL",
    "ctypes.cdll.LoadLibrary"}

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.DictComp, ast.ListComp,
               ast.SetComp)

_TORCH_DRAWS = {f"torch.{n}" for n in (
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "bernoulli", "multinomial", "normal", "poisson")}
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
_SEEDED_NUMPY = {"default_rng", "Generator", "SeedSequence", "RandomState",
                 "BitGenerator", "PCG64", "PCG64DXSM", "Philox", "SFC64",
                 "MT19937"}


def _rebuilds(path: Optional[str]) -> bool:
    """Whether a resolved callee builds a graph or loads a library."""
    return bool(path) and (path in _REBUILD_PATHS or path == "_build.library"
                           or path.endswith("._build.library"))


def _keyword(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


class HygieneChecker:
    code_prefix = "RA1"
    name = "hygiene"

    def check(self, src: SourceFile) -> List[Finding]:
        imports = Imports(src.tree)
        return self._rebuild(src, imports) + self._id_caches(src) + \
            self._cache_args(src, imports)

    # -- RA101 / RA102 ---------------------------------------------------
    def _rebuild(self, src: SourceFile, imports: Imports) -> List[Finding]:
        calls = [n for n in src.nodes if isinstance(n, ast.Call)]
        rebuilds = [n for n in calls if _rebuilds(call_path(imports, n))]
        compiled = [n for n in calls if isinstance(n.func, ast.Call)
                    and call_path(imports, n.func) in _COMPILE_PATHS]
        out = []
        if rebuilds:
            in_loop = enclosing_loops(src.tree)
            for node in rebuilds:
                if in_loop.get(id(node)):
                    out.append(Finding(
                        "RA101", src.path, node.lineno, node.col_offset,
                        f"{call_path(imports, node)}() called inside a "
                        f"loop body — each iteration builds a new compiled "
                        f"graph, captured graph or loaded library; hoist "
                        f"it out of the loop or cache it"))
        if compiled:
            in_function = {id(n) for fn in walk_functions(src.tree)
                           for n in ast.walk(fn)}
            for node in compiled:
                if id(node) in in_function:
                    out.append(Finding(
                        "RA102", src.path, node.lineno, node.col_offset,
                        f"{call_path(imports, node.func)}(...) immediately "
                        f"called — the compiled function is rebuilt on "
                        f"every invocation; bind it once (module level or "
                        f"a bounded cache) and reuse it"))
        out.sort(key=lambda f: (f.line, f.col))
        return out

    # -- RA103 -----------------------------------------------------------
    def _id_caches(self, src: SourceFile) -> List[Finding]:
        # Names bound to a bare dict anywhere in the file.
        plain_dicts: Set[str] = set()
        for node in src.nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = node.value
                is_dict = isinstance(v, ast.Dict) or (
                    isinstance(v, ast.Call)
                    and isinstance(v.func, ast.Name)
                    and v.func.id == "dict" and not v.args)
                if is_dict:
                    plain_dicts.add(node.targets[0].id)

        def key_uses_id(expr: ast.AST) -> bool:
            return any(isinstance(n, ast.Call)
                       and isinstance(n.func, ast.Name)
                       and n.func.id == "id" for n in ast.walk(expr))

        out = []
        for node in src.nodes:
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Subscript) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in plain_dicts \
                        and key_uses_id(t.slice):
                    out.append(Finding(
                        "RA103", src.path, t.lineno, t.col_offset,
                        f"store into plain dict {t.value.id!r} keyed by "
                        f"id(...) — the dict grows without bound and a "
                        f"recycled id aliases a dead entry; use a "
                        f"bounded LRU that pins the keyed object "
                        f"(see serve.engine._StepCache)"))
        return out

    # -- RA105 -----------------------------------------------------------
    def _cache_args(self, src: SourceFile, imports: Imports
                    ) -> List[Finding]:
        def is_cache(node: ast.AST) -> bool:
            # functools.cache, functools.lru_cache, lru_cache(maxsize=...)
            target = node.func if isinstance(node, ast.Call) else node
            path = imports.resolve(target)
            return path in ("functools.cache", "functools.lru_cache")

        if "functools" not in set(imports.modules.values()) | {
                m for m, _ in imports.names.values()}:
            return []
        cached: Set[str] = {
            fn.name for fn in src.nodes
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            and any(is_cache(d) for d in fn.decorator_list)}
        for node in src.nodes:
            # f = functools.cache(g) / functools.lru_cache(maxsize=8)(g)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Call) \
                    and is_cache(node.value.func):
                cached.add(node.targets[0].id)

        out = []
        for node in src.nodes:
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in cached):
                continue
            args = [(f"argument {i}", a) for i, a in enumerate(node.args)]
            args += [(f"argument {kw.arg!r}", kw.value)
                     for kw in node.keywords if kw.arg]
            for what, arg in args:
                if isinstance(arg, _UNHASHABLE):
                    out.append(Finding(
                        "RA105", src.path, arg.lineno, arg.col_offset,
                        f"unhashable literal as {what} of cached function "
                        f"{node.func.id!r} — functools caches hash their "
                        f"arguments and raise TypeError; pass a tuple"))
        return out


class GlobalRngChecker:
    """RA104: draws from a global generator (module docstring)."""
    code_prefix = "RA1"
    name = "global-rng"

    def check(self, src: SourceFile) -> List[Finding]:
        imports = Imports(src.tree)
        out = []
        for node in src.nodes:
            if not isinstance(node, ast.Call):
                continue
            what = self._global_draw(imports, node)
            if what:
                out.append(Finding(
                    "RA104", src.path, node.lineno, node.col_offset,
                    f"{what} draws from a global generator — the port's "
                    f"runs replay and resume bitwise from seeded "
                    f"generators; pass generator= (or use a seeded "
                    f"random.Random / np.random.default_rng)"))
        return out

    @staticmethod
    def _global_draw(imports: Imports, call: ast.Call) -> Optional[str]:
        path = imports.resolve(call.func) or ""
        gen = _keyword(call, "generator")
        no_gen = gen is None or (isinstance(gen, ast.Constant)
                                 and gen.value is None)
        if path in _TORCH_DRAWS and no_gen:
            return f"{path}()"
        parts = dotted_name(call.func) or []
        if isinstance(call.func, ast.Attribute) and not path \
                and call.func.attr in _INPLACE_DRAWS and no_gen:
            return f"Tensor.{call.func.attr}()"
        if parts and parts[-1] == "dropout" and (
                path.startswith("torch.") or not path):
            return f"{'.'.join(parts)}()"
        mod, _, fn = path.rpartition(".")
        if mod == "random" and fn != "Random":
            return f"{path}()"
        if mod == "numpy.random" and fn not in _SEEDED_NUMPY:
            return f"{path}()"
        return None
