"""Shared infrastructure of the port's static-analysis gate.

The port's counterpart of the reference's ``analysis/base.py``
(DESIGN.md §14): one :class:`Finding` per diagnostic, keyed stably by
``(code, path, message)`` so the committed baseline survives unrelated
edits; a :class:`SourceFile` that holds the parsed source and its
``repro-lint: disable=CODE <reason>`` map; an :class:`Imports` map so a
checker can tell ``torch.compile`` from a local ``compile``; and small
resolution helpers.

A ``.py`` file is parsed with :mod:`ast` and its disables come from real
``#`` comment tokens.  A ``.cu`` file is read in text mode: nothing is
parsed as Python, its comments and string literals are lexed
(:func:`lex_c`), and its disables come from ``//`` and ``/* */``
comments.  In either, ``disable=`` suppresses on the comment's own line
and ``disable-next=`` on the line after it; a disable without a reason,
or naming a code outside :data:`CODES`, is itself a finding (RA001).

The codes keep the reference's numbers wherever the bug class is the
same, so a ``# repro-lint: disable=RA301 ...`` in a port ``.py`` file
means one thing to both gates.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import functools
import io
import re
import tokenize
from typing import Dict, List, Optional, Set, Tuple

# The catalog: one line a code.  RA201 has no checker in the port.
CODES: Dict[str, str] = {
    "RA000": "file does not parse (a .py file as Python; a .cu file: an "
             "unterminated comment or string, or unbalanced brackets)",
    "RA001": "repro-lint disable comment without a reason or with an "
             "unknown code",
    "RA101": "torch.compile, torch.jit.script/trace, a CUDA graph "
             "capture, ctypes.CDLL or _build.library inside a loop body "
             "(rebuilt every iteration)",
    "RA102": "torch.compile(f)(x) / torch.jit.script(f)(x) immediately "
             "called (rebuilt on every call of the enclosing function)",
    "RA103": "unbounded plain-dict cache keyed by id(...)",
    "RA104": "a draw from a global generator in src/repro_torch/ "
             "(torch.rand*/randint/randperm/bernoulli/multinomial/normal/"
             "dropout without generator=, random.*, legacy np.random.*): "
             "breaks bitwise replay and resume",
    "RA105": "unhashable literal passed to a functools.cache/lru_cache "
             "function of the same module",
    "RA201": "no counterpart: eager PyTorch donates no buffer, so no "
             "array can be read after donation (the reference's "
             "jax.jit donate_argnums check has nothing to check here)",
    "RA301": "arithmetic mixes unit families (bytes/elems/mb/mbps) "
             "without an explicit conversion",
    "RA302": "value of one unit family bound to a name of another "
             "(assignment, keyword, parameter, or return)",
    "RA401": "import of jax, jaxlib, ml_dtypes or the reference package "
             "repro from a port file (the port stands alone)",
    "RA501": "CUDA launch whose grid arity differs from the blockIdx/"
             "gridDim axes its __global__ kernel reads",
    "RA502": "CUDA launch whose grid extent is a floor division (or a "
             "min() cap) that the kernel does not walk by gridDim: the "
             "ragged tail gets no block",
    "RA503": "tensor-core MMA (wgmma.mma_async, mma.sync, wmma "
             "accumulator fragment) accumulating below f32 (s32 for "
             "integer shapes)",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    code: str
    path: str          # repo-relative posix path
    line: int
    col: int
    message: str       # stable: must not embed line/col numbers

    @property
    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: survives line-number churn."""
        return (self.code, self.path, self.message)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} " \
               f"{self.message}"

    def to_json(self) -> Dict:
        return {"code": self.code, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}


# ``repro-lint: disable=RA101,RA102 <reason>`` on the flagged line, or
# ``disable-next=...`` on the line above it.
_DISABLE_RE = re.compile(
    r"repro-lint:\s*(disable|disable-next)=([A-Za-z0-9,]+)\s*(.*)$")

# C/C++ comments, string and character literals; a lone opener is an
# unterminated one.
_C_TOKEN = re.compile(r"//[^\n]*|/\*.*?\*/|\"(?:\\.|[^\"\\\n])*\""
                      r"|'(?:\\.|[^'\\\n])*'|/\*|\"|'", re.S)
_BRACKETS = {")": "(", "]": "[", "}": "{"}


@dataclasses.dataclass
class Lexed:
    """A C/C++ source split for analysis.  ``code`` is the text with
    every comment blanked; ``skel`` also blanks every literal's contents
    (quotes kept), so brackets and names can be matched on it; both keep
    each character's offset.  ``strings`` holds ``(text, offsets)`` of
    each string literal, adjacent literals merged as the compiler merges
    them, ``offsets[i]`` the offset in the source of ``text[i]``;
    ``comments`` holds ``(line, text)``."""
    code: str
    skel: str
    strings: List[Tuple[str, List[int]]]
    comments: List[Tuple[int, str]]
    error: Optional[str]
    _newlines: List[int]

    def line_of(self, offset: int) -> int:
        return bisect.bisect_right(self._newlines, offset - 1) + 1

    def col_of(self, offset: int) -> int:
        i = bisect.bisect_right(self._newlines, offset - 1)
        return offset - (self._newlines[i - 1] + 1 if i else 0)


def lex_c(text: str) -> Lexed:
    """Lex ``text`` as C/C++ (see :class:`Lexed`); ``error`` names the
    first unterminated comment or literal, or unbalanced bracket."""
    code, skel = list(text), list(text)
    strings: List[Tuple[str, List[int]]] = []
    comments: List[Tuple[int, str]] = []
    newlines = [i for i, c in enumerate(text) if c == "\n"]
    last_end = 0
    lexed = Lexed("", "", strings, comments, None, newlines)
    for m in _C_TOKEN.finditer(text):
        tok, a, b = m.group(0), m.start(), m.end()
        if tok in ("/*", '"', "'"):
            what = "comment" if tok == "/*" else "literal"
            lexed.error = f"unterminated {what} at line {lexed.line_of(a)}"
            break
        if tok.startswith("/"):
            comments.append((lexed.line_of(a), tok))
            for i in range(a, b):
                if text[i] != "\n":
                    code[i] = skel[i] = " "
            continue
        for i in range(a + 1, b - 1):
            skel[i] = " "
        if tok[0] == '"':
            offsets = list(range(a + 1, b - 1))
            if strings and not "".join(code[last_end:a]).strip():
                text_, offs = strings[-1]
                strings[-1] = (text_ + tok[1:-1], offs + offsets)
            else:
                strings.append((tok[1:-1], offsets))
            last_end = b
    lexed.code, lexed.skel = "".join(code), "".join(skel)
    if lexed.error is None:
        stack: List[Tuple[str, int]] = []
        for i, c in enumerate(lexed.skel):
            if c in "([{":
                stack.append((c, i))
            elif c in ")]}":
                if not stack or stack[-1][0] != _BRACKETS[c]:
                    lexed.error = f"unbalanced {c!r} at line " \
                                  f"{lexed.line_of(i)}"
                    break
                stack.pop()
        else:
            if stack:
                lexed.error = f"unclosed {stack[-1][0]!r} at line " \
                              f"{lexed.line_of(stack[-1][1])}"
    return lexed


class SourceFile:
    """One source file plus its disable-comment map: a ``.py`` file
    parsed as Python (``tree``), a ``.cu`` file lexed as C++ (``lexed``;
    ``tree`` is then an empty module)."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.parse_error: Optional[str] = None
        self.tree: ast.AST = ast.Module(body=[], type_ignores=[])
        self.lexed: Optional[Lexed] = None
        if self.is_cuda:
            self.lexed = lex_c(text)
            self.parse_error = self.lexed.error
            comments = self.lexed.comments
        else:
            try:
                self.tree = ast.parse(text)
            except SyntaxError as e:  # surfaced as RA000 by the runner
                self.parse_error = str(e)
            comments = self._py_comments()
        # line -> set of codes disabled on that line
        self.disables: Dict[int, Set[str]] = {}
        # meta-findings about the disable comments themselves (RA001)
        self.disable_findings: List[Finding] = []
        for line, comment in comments:
            self._disable(line, comment)

    @functools.cached_property
    def nodes(self) -> List[ast.AST]:
        """Every node of ``tree``, walked once for all checkers."""
        return list(ast.walk(self.tree))

    @property
    def is_cuda(self) -> bool:
        return self.path.endswith(".cu")

    def _py_comments(self) -> List[Tuple[int, str]]:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.text).readline)
            return [(t.start[0], t.string) for t in tokens
                    if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return []

    def _disable(self, line: int, comment: str) -> None:
        # a block comment may span lines: each line is its own comment
        for i, part in enumerate(comment.split("\n")):
            m = _DISABLE_RE.search(part.rstrip().removesuffix("*/"))
            if not m:
                continue
            at = line + i
            kind, codes_s, reason = m.groups()
            codes = {c.strip() for c in codes_s.split(",") if c.strip()}
            target = at + 1 if kind == "disable-next" else at
            unknown = sorted(c for c in codes if c not in CODES)
            if unknown:
                self.disable_findings.append(Finding(
                    "RA001", self.path, at, 0,
                    f"disable comment names unknown code(s) "
                    f"{', '.join(unknown)}"))
            if not reason.strip(" -:;"):
                self.disable_findings.append(Finding(
                    "RA001", self.path, at, 0,
                    f"disable={','.join(sorted(codes))} has no reason — "
                    f"every suppression must say why"))
            self.disables.setdefault(target, set()).update(codes)

    def disabled(self, finding: Finding) -> bool:
        return finding.code in self.disables.get(finding.line, set())


class Imports:
    """Per-file import map: resolve local names to dotted module paths.

    ``modules`` maps a bound name to the module it denotes
    (``import a.b as c`` -> ``c: a.b``; ``import a.b`` -> ``a: a`` with
    the full path reachable through attribute chains).  ``names`` maps a
    bound name from ``from M import n [as k]`` to ``(M, n)``.
    """

    def __init__(self, tree: ast.AST):
        self.modules: Dict[str, str] = {}
        self.names: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        self.modules[alias.asname] = alias.name
                    else:
                        root = alias.name.split(".")[0]
                        self.modules[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for alias in node.names:
                    bound = alias.asname or alias.name
                    self.names[bound] = (node.module, alias.name)

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Fully-qualified dotted path of a Name/Attribute chain, or
        ``None`` when the root is not an import binding."""
        parts = dotted_name(node)
        if not parts:
            return None
        root, rest = parts[0], parts[1:]
        if root in self.names:
            mod, orig = self.names[root]
            return ".".join([mod, orig] + rest)
        if root in self.modules:
            return ".".join([self.modules[root]] + rest)
        return None


def dotted_name(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` attribute chain as ``["a", "b", "c"]`` (Name roots
    only)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def call_path(imports: Imports, call: ast.Call) -> Optional[str]:
    """Resolved dotted path of a call's callee (``torch.compile``,
    ``ctypes.CDLL``, ...), or the raw dotted text when the root is a local
    binding rather than an import."""
    resolved = imports.resolve(call.func)
    if resolved:
        return resolved
    parts = dotted_name(call.func)
    return ".".join(parts) if parts else None


def walk_functions(tree: ast.AST):
    """Every FunctionDef/AsyncFunctionDef in the file, including nested
    ones."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def enclosing_loops(tree: ast.AST) -> Dict[int, bool]:
    """Map ``id(node) -> True`` for nodes lexically inside a for/while
    body.  Loop iter/condition expressions do not count as "inside", nor
    does the body of a function merely defined in a loop."""
    inside: Dict[int, bool] = {}

    def mark(node: ast.AST, flag: bool) -> None:
        inside[id(node)] = flag
        if isinstance(node, (ast.For, ast.AsyncFor)):
            for child in [node.target, node.iter]:
                mark(child, flag)
            for child in node.body + node.orelse:
                mark(child, True)
            return
        if isinstance(node, ast.While):
            mark(node.test, flag)
            for child in node.body + node.orelse:
                mark(child, True)
            return
        flag = flag and not isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
        for child in ast.iter_child_nodes(node):
            mark(child, flag)

    mark(tree, False)
    return inside
