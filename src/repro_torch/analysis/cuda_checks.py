"""CUDA kernel checks (RA501–RA503) over ``src/repro_torch/kernels/csrc``.

The port's counterpart of the reference's ``pallas_checks.py``.  The
three Pallas contracts it pins have CUDA twins:

* **RA501 — grid arity.**  A ``__global__`` kernel that reads
  ``blockIdx.y``/``.z`` (or ``gridDim.y``/``.z``) launched with a 1-D
  grid sees that axis at 0 in every block; one launched with a ``dim3``
  of more axes than it reads repeats the same work along the extras (the
  Pallas ``index_map`` that drops a grid axis).  The axes a kernel reads
  include those of the ``__device__`` functions it calls.
* **RA502 — block coverage.**  Each grid extent of a launch must cover
  its array: a ceiling division of an extent by a tile
  (``(n + b - 1) / b``, or a product with one) covers it, a floor
  division drops the ragged tail, and a ``min()`` cap drops everything
  past the cap — unless the kernel walks the rest by ``gridDim`` on that
  axis (a persistent grid).  Names are followed through the launching
  function's assignments and the file's constants.
* **RA503 — f32 accumulation.**  Every ``wgmma.mma_async`` and
  ``mma.sync`` PTX string must name ``.f32`` as its D type (and, for
  ``mma.sync``, its C type), ``.s32`` for integer shapes; every
  ``wmma::fragment<wmma::accumulator, ...>`` must hold ``float``.

Resolution is conservative, as in the reference: a launch whose kernel is
a template parameter, a grid passed in as a parameter, or an extent built
from parameters alone is unknown, and unknown never flags.  The checks
read the committed ``csrc/*.cu`` only: the patched sources that the
``*_variants.py`` modules build are out of their scope.

:func:`mma_sites` and :func:`check_sass` also serve the card:
``chip_smoke.py`` holds every MMA site found here against the SASS that
``nvcc`` emitted for it (``cuobjdump -sass``), and every ``HMMA`` /
``HGMMA`` there to an ``F32`` accumulator.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.analysis.base import Finding, Lexed, SourceFile

CEIL, FLOOR, CAP, CONST, UNKNOWN = "ceil", "floor", "cap", "const", "unknown"
AXES = "xyz"

# Words that take a parenthesised operand but name no function.
_NOT_FUNCTIONS = {
    "if", "for", "while", "switch", "return", "sizeof", "catch", "do",
    "else", "case", "new", "delete", "throw", "noexcept", "decltype",
    "alignof", "alignas", "static_assert", "defined", "asm", "volatile",
    "__launch_bounds__", "__align__", "__attribute__", "__declspec",
    "static_cast", "reinterpret_cast", "const_cast", "dynamic_cast",
    "operator", "template", "typename"}
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;{}()<>]*(?:<[^;{}()<>]*>"
                   r"[^;{}()<>]*)*>)?\s*\(")
_READS = re.compile(r"\b(blockIdx|gridDim)\s*\.\s*([xyz])\b")
_PAIRS = {"(": ")", "[": "]", "{": "}"}

# An instruction starts a literal's text, or follows a separator or an
# escape (``"...;\\nwgmma..."``).
_PTX_MMA = re.compile(
    r"(?:(?<=\\[nt])|(?<![\w.]))"
    r"(wgmma\.mma_async(?:\.sp)?\.sync|mma(?:\.sp)?\.sync)"
    r"\.aligned\.(m\d+n\d+k\d+)((?:\.\w+)*)")
_PTX_MODIFIERS = {"row", "col", "satfinite"}
_INT_TYPES = {"s8", "u8", "s4", "u4", "b1"}
_WMMA_ACC = re.compile(r"\bwmma::fragment\s*<\s*(?:nvcuda::)?"
                       r"wmma::accumulator\s*,([^<>;]*)>")
_WMMA_OK = {"float", "int", "double"}


def _match(text: str, i: int) -> int:
    """Index of the bracket closing the one at ``text[i]`` (-1 if none)."""
    opener, closer, depth = text[i], _PAIRS[text[i]], 0
    for j in range(i, len(text)):
        if text[j] == opener:
            depth += 1
        elif text[j] == closer:
            depth -= 1
            if depth == 0:
                return j
    return -1


def _split_top(text: str) -> List[str]:
    """``text`` split at its commas outside brackets."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(text):
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == "," and depth == 0:
            parts.append(text[start:i].strip())
            start = i + 1
    parts.append(text[start:].strip())
    return [p for p in parts if p]


@dataclasses.dataclass
class Function:
    name: str
    start: int                   # offset of the name
    params: str
    body: Tuple[int, int]        # offsets of its braces
    kernel: bool = False


def functions(lexed: Lexed) -> List[Function]:
    """Every function definition (``name[<args>](params) [const] { ...
    }``), in source order; ``kernel`` marks the ``__global__`` ones."""
    skel, out = lexed.skel, []
    for m in _CALL.finditer(skel):
        if m.group(1) in _NOT_FUNCTIONS:
            continue
        close = _match(skel, m.end() - 1)
        after = re.match(r"\s*(?:(?:const|noexcept|override)\b\s*)*\{",
                         skel[close + 1:])
        if close < 0 or not after:
            continue
        b0 = close + after.end()
        out.append(Function(m.group(1), m.start(1),
                            skel[m.end():close], (b0, _match(skel, b0))))
    starts = [f.start for f in out]
    for g in re.finditer(r"\b__global__\b", skel):
        i = bisect.bisect_right(starts, g.start())
        if i < len(out):
            out[i].kernel = True
    return out


def _reads(lexed: Lexed, fns: List[Function]) -> Dict[str, Set[str]]:
    """``name -> {"blockIdx.y", "gridDim.x", ...}``: what each function
    reads itself or through the functions of the file it calls."""
    direct: Dict[str, Set[str]] = {}
    calls: Dict[str, Set[str]] = {}
    names = {f.name for f in fns}
    for f in fns:
        body = lexed.skel[f.body[0]:f.body[1]]
        direct.setdefault(f.name, set()).update(
            f"{k}.{a}" for k, a in _READS.findall(body))
        calls.setdefault(f.name, set()).update(
            n for n in _CALL.findall(body) if n in names and n != f.name)
    out: Dict[str, Set[str]] = {}
    for name in direct:
        seen, todo, reads = {name}, [name], set()
        while todo:
            n = todo.pop()
            reads |= direct[n]
            for c in calls[n] - seen:
                seen.add(c)
                todo.append(c)
        out[name] = reads
    return out


def axes_read(reads: Set[str]) -> int:
    """How many grid axes a kernel uses: 1 + the highest axis read."""
    return max((AXES.index(r[-1]) + 1 for r in reads), default=1)


# -- expressions -------------------------------------------------------------

_FUNCTIONAL_CAST = re.compile(
    r"(?:static_cast|unsigned|int|long long|long|size_t|int64_t|uint32_t)"
    r"\s*\(")
_C_CAST = re.compile(r"\(\s*(?:unsigned|int|long long|long|size_t|int64_t|"
                     r"uint32_t|unsigned int|unsigned long long)\s*\)\s*")


def _unwrap(e: str) -> str:
    """``e`` without whitespace runs, enclosing parentheses and casts."""
    e = re.sub(r"static_cast\s*<[^<>]*>", "static_cast", " ".join(e.split()))
    while True:
        e = e.strip()
        if e.startswith("(") and _match(e, 0) == len(e) - 1:
            e = e[1:-1]
            continue
        m = _FUNCTIONAL_CAST.match(e) or _C_CAST.match(e)
        if m and m.group(0).startswith("("):
            e = e[m.end():]
            continue
        if m and _match(e, m.end() - 1) == len(e) - 1:
            e = e[m.end():-1]
            continue
        return e


def _binary_at(e: str, ops: str) -> Optional[int]:
    """Index of the rightmost binary operator of ``ops`` outside
    brackets (the root of a left-associative chain), or None."""
    depth, found = 0, None
    for i, c in enumerate(e):
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif depth == 0 and c in ops:
            prev = e[:i].rstrip()
            if not prev or prev[-1] in "+-*/%<>=&|^!?:,(":
                continue                       # unary
            if e[i:i + 2] == "->" or (c in "+-" and re.search(
                    r"\d\.?\d*[eE]$", prev)):  # member access, 1e-5
                continue
            found = i
    return found


def _is_ceil(num: str, den: str) -> bool:
    """Whether ``num / den`` is a ceiling division: ``num`` is
    ``x + den - 1`` (or ``x + (den - 1)``, or ``x + c`` with ``c`` the
    literal ``den - 1``)."""
    n, d = _unwrap(num).replace(" ", ""), _unwrap(den).replace(" ", "")
    tails = [f"+{d}-1", f"+({d}-1)", f"-1+{d}"]
    if re.fullmatch(r"\d+", d):
        tails.append(f"+{int(d) - 1}")
    return any(n.endswith(t) and len(n) > len(t) for t in tails)


def classify(expr: str, resolve: Callable[[str], Optional[str]],
             depth: int = 0) -> str:
    """What a grid extent covers: CEIL (a ceiling division, or a product
    with one), FLOOR (a floor division, or a product with one), CAP (a
    ``min()``), CONST (literals), else UNKNOWN.  ``resolve`` maps a name
    to the expression it was last assigned, or None."""
    e = _unwrap(expr)
    if re.fullmatch(r"\d+[uUlL]*", e):
        return CONST
    if depth > 8 or re.search(r"[?<>=&|^]", e):
        return UNKNOWN
    if _binary_at(e, "+-") is not None:
        return UNKNOWN
    i = _binary_at(e, "*/%")
    if i is not None:
        left, op, right = e[:i], e[i], e[i + 1:]
        if op == "/":
            return CEIL if _is_ceil(left, right) else FLOOR
        if op == "%":
            return UNKNOWN
        kinds = {classify(left, resolve, depth + 1),
                 classify(right, resolve, depth + 1)}
        for kind in (FLOOR, CAP, CEIL):
            if kind in kinds:
                return kind
        return CONST if kinds == {CONST} else UNKNOWN
    m = re.match(r"(?:std::)?(\w+)\s*\(", e)
    if m and _match(e, m.end() - 1) == len(e) - 1:
        name = m.group(1).lower()
        if name in ("ceil_div", "cdiv", "div_up", "ceildiv"):
            return CEIL
        return CAP if name == "min" else UNKNOWN
    if re.fullmatch(r"[A-Za-z_]\w*", e):
        value = resolve(e)
        return UNKNOWN if value is None else classify(value, resolve,
                                                      depth + 1)
    return UNKNOWN


# -- launches ----------------------------------------------------------------

@dataclasses.dataclass
class Launch:
    """One ``kernel<<<grid, ...>>>`` site.  ``kernel`` is None where it
    is not a ``__global__`` function of the file (a template parameter);
    ``grid`` holds the extent of each axis launched (None: unknown);
    ``kinds`` what each extent covers ("persistent" where the kernel
    walks that axis by gridDim); ``reads`` the kernel's blockIdx /
    gridDim reads."""
    line: int
    col: int
    kernel: Optional[str]
    grid: Optional[List[str]]
    kinds: Optional[List[str]]
    reads: Optional[Set[str]]


def _kernel_before(skel: str, at: int) -> str:
    """The callee named before ``<<<`` at ``at``, template arguments
    dropped."""
    j = len(skel[:at].rstrip())
    if j and skel[j - 1] == ">":
        depth = 0
        for k in range(j - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(skel[k], 0)
            if depth == 0:
                j = len(skel[:k].rstrip())
                break
    m = re.search(r"([A-Za-z_]\w*)$", skel[:j])
    return m.group(1) if m else ""


class _Scope:
    """Name resolution at a launch: the launching function's assignments
    before it, else the constants declared outside every function."""

    def __init__(self, lexed: Lexed, fns: List[Function],
                 fn: Optional[Function], at: int):
        self.before = lexed.skel[fn.body[0]:at] if fn else ""
        self.params = fn.params if fn else ""
        self.skel = lexed.skel
        self.bodies = [f.body for f in fns]

    def _assignment(self, name: str) -> Tuple[int, Optional[str]]:
        pat = rf"(?<![\w.>:]){re.escape(name)}\s*=(?!=)\s*([^;]*);"
        found = list(re.finditer(pat, self.before))
        if found:
            return found[-1].start(), found[-1].group(1)
        for m in re.finditer(rf"\bconst(?:expr)?\b[^;{{}}()]*\b"
                             rf"{re.escape(name)}\s*=\s*([^;]*);",
                             self.skel):
            if not any(a < m.start() < b for a, b in self.bodies):
                return -1, m.group(1)
        return -1, None

    def assigned(self, name: str) -> Optional[str]:
        return self._assignment(name)[1]

    def grid(self, expr: str) -> Optional[List[str]]:
        """Each axis's extent of a launch's grid argument (None:
        unknown)."""
        e = _unwrap(expr)
        m = re.match(r"dim3\s*[({]", e)
        if m and _match(e, m.end() - 1) == len(e) - 1:
            args = _split_top(e[m.end():-1])
        elif re.fullmatch(r"[A-Za-z_]\w*", e):
            ctors = list(re.finditer(rf"\bdim3\s+{e}\s*[({{]",
                                     self.before))
            at, value = self._assignment(e)
            if ctors and ctors[-1].start() > at:
                k = ctors[-1].end() - 1
                args = _split_top(self.before[k + 1:_match(self.before, k)])
            elif value is not None:
                return self.grid(value)
            elif re.search(rf"\bdim3\b[^,]*\b{e}\b", self.params):
                return None
            elif re.search(rf"\b{e}\b", self.params):
                args = [e]
            else:
                return None
        else:
            args = [e]
        while len(args) > 1 and re.fullmatch(r"1[uU]?", args[-1]):
            args.pop()
        return args


def launches(lexed: Lexed, fns: Optional[List[Function]] = None
             ) -> List[Launch]:
    """Every ``<<<...>>>`` launch in the file, resolved as far as the
    source allows."""
    fns = functions(lexed) if fns is None else fns
    reads = _reads(lexed, fns)
    kernels = {f.name for f in fns if f.kernel}
    skel, out = lexed.skel, []
    for m in re.finditer(r"<<<", skel):
        end, depth = m.end(), 0
        while end < len(skel) and not (depth == 0 and
                                       skel.startswith(">>>", end)):
            depth += {"(": 1, ")": -1}.get(skel[end], 0)
            end += 1
        config = _split_top(skel[m.end():end])
        name = _kernel_before(skel, m.start())
        inside = [f for f in fns if f.body[0] < m.start() < f.body[1]]
        fn = max(inside, key=lambda f: f.body[0]) if inside else None
        scope = _Scope(lexed, fns, fn, m.start())
        grid = scope.grid(config[0]) if config else None
        kernel = name if name in kernels else None
        kinds = None
        if grid is not None and kernel:
            kinds = ["persistent" if f"gridDim.{AXES[i]}" in reads[kernel]
                     else classify(x, scope.assigned)
                     for i, x in enumerate(grid)]
        out.append(Launch(lexed.line_of(m.start()), lexed.col_of(m.start()),
                          kernel, grid, kinds,
                          reads[kernel] if kernel else None))
    return out


# -- MMA sites ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mma:
    """One tensor-core product in the source: ``op`` is "wgmma",
    "mma.sync" or "wmma"; ``acc`` the accumulator types it names (D, and
    C for ``mma.sync``); ``atype`` the A operand's type."""
    line: int
    col: int
    op: str
    shape: str
    acc: Tuple[str, ...]
    atype: str


def mma_sites(lexed: Lexed) -> List[Mma]:
    """Every ``wgmma.mma_async`` / ``mma.sync`` PTX string and every
    ``wmma`` accumulator fragment of the file."""
    out = []
    for text, offsets in lexed.strings:
        for m in _PTX_MMA.finditer(text):
            at = offsets[m.start()]
            types = [t for t in m.group(3).split(".")[1:]
                     if t not in _PTX_MODIFIERS]
            op = "wgmma" if m.group(1).startswith("wgmma") else "mma.sync"
            acc = tuple(types[:1] + (types[3:4] if op == "mma.sync"
                                     else []))
            out.append(Mma(lexed.line_of(at), lexed.col_of(at), op,
                           m.group(2), acc,
                           types[1] if len(types) > 1 else ""))
    for m in _WMMA_ACC.finditer(lexed.skel):
        args = _split_top(m.group(1))
        out.append(Mma(lexed.line_of(m.start()), lexed.col_of(m.start()),
                       "wmma", "m{}n{}k{}".format(*args[:3])
                       if len(args) >= 4 else "", (args[-1],) if args
                       else (), ""))
    return sorted(out, key=lambda s: (s.line, s.col))


def _acc_ok(site: Mma) -> bool:
    if site.op == "wmma":
        return all(a in _WMMA_OK for a in site.acc)
    want = "s32" if site.atype in _INT_TYPES else (
        "f64" if site.atype == "f64" else "f32")
    return bool(site.acc) and all(a == want for a in site.acc)


class CudaChecker:
    code_prefix = "RA5"
    name = "cuda"

    def check(self, src: SourceFile) -> List[Finding]:
        lexed = src.lexed
        if lexed is None:
            return []
        out = []
        for ln in launches(lexed):
            if ln.kernel is None or ln.grid is None:
                continue
            n_read, n_grid = axes_read(ln.reads), len(ln.grid)
            if n_read != n_grid:
                read = ", ".join(sorted(ln.reads)) or "no grid axis"
                out.append(Finding(
                    "RA501", src.path, ln.line, ln.col,
                    f"{ln.kernel} reads {read} but is launched with a "
                    f"{n_grid}-D grid — "
                    + ("every block sees the missing axes at 0"
                       if n_read > n_grid else
                       "blocks along the extra axes repeat the same "
                       "work")))
            for axis, (extent, kind) in enumerate(zip(ln.grid, ln.kinds)):
                if kind in (FLOOR, CAP):
                    what = "a floor division" if kind == FLOOR \
                        else "a min() cap"
                    out.append(Finding(
                        "RA502", src.path, ln.line, ln.col,
                        f"{ln.kernel}: grid extent {AXES[axis]} "
                        f"`{' '.join(extent.split())}` is {what} and the "
                        f"kernel does not walk gridDim.{AXES[axis]} — "
                        f"the ragged tail gets no block; launch "
                        f"(n + b - 1) / b blocks or walk the rest by "
                        f"gridDim"))
        for site in mma_sites(lexed):
            if not _acc_ok(site):
                acc = ", ".join(site.acc) or "no type"
                out.append(Finding(
                    "RA503", src.path, site.line, site.col,
                    f"{site.op} {site.shape} accumulates in {acc} — a "
                    f"tensor-core product must accumulate in f32 (s32 "
                    f"for integer shapes)"))
        return out


# -- the card: SASS ----------------------------------------------------------

_SASS_MMA = re.compile(r"\b(HGMMA|HMMA)\.(\w+)((?:\.\w+)*)")
_SASS_TYPES = {"F32", "F16", "BF16", "TF32", "E4M3", "E5M2", "S8", "U8",
               "S32", "F64"}


@dataclasses.dataclass(frozen=True)
class SassMma:
    function: str
    op: str                      # "HGMMA" or "HMMA"
    shape: Tuple[int, int, int]  # (m, n, k)
    dtype: str                   # the accumulator's
    atype: str
    text: str


def _sass_shape(op: str, s: str) -> Optional[Tuple[int, int, int]]:
    if op == "HGMMA":
        m = re.fullmatch(r"(\d+)x(\d+)x(\d+)", s)
        return tuple(int(x) for x in m.groups()) if m else None
    m = re.fullmatch(r"(16)(8)(\d+)|(8)(8)(\d+)", s)
    if not m:
        return None
    g = [x for x in m.groups() if x is not None]
    return int(g[0]), int(g[1]), int(g[2])


def sass_mmas(sass: str) -> List[SassMma]:
    """Every HMMA and HGMMA of a ``cuobjdump -sass`` listing, with the
    function it sits in."""
    out, fn = [], ""
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        for m in _SASS_MMA.finditer(line):
            shape = _sass_shape(m.group(1), m.group(2))
            types = [t for t in m.group(3).split(".")[1:]
                     if t in _SASS_TYPES]
            if shape is None or not types:
                continue
            out.append(SassMma(fn, m.group(1), shape, types[0],
                               types[1] if len(types) > 1 else "F16",
                               m.group(0)))
    return out


def _shape(s: str) -> Tuple[int, int, int]:
    m = re.fullmatch(r"m(\d+)n(\d+)k(\d+)", s)
    return tuple(int(x) for x in m.groups()) if m else (0, 0, 0)


def check_sass(sites: List[Mma], sass: str) -> Tuple[int, List[str]]:
    """``(instructions checked, problems)``: every HMMA / HGMMA of
    ``sass`` must accumulate in F32, and each PTX site of ``sites`` must
    appear there: a ``wgmma`` as an HGMMA of its shape and A type, an
    ``mma.sync`` as an HMMA of its M, N and A type whose K divides its K
    (ptxas may issue a product as several narrower ones)."""
    found = sass_mmas(sass)
    problems = [f"{i.function}: {i.text} accumulates in {i.dtype}"
                for i in found if i.dtype != "F32"]
    for s in sites:
        m, n, k = _shape(s.shape)
        a = s.atype.upper()
        if s.op == "wgmma":
            hit = any(i.op == "HGMMA" and i.shape == (m, n, k)
                      and i.atype == a for i in found)
        elif s.op == "mma.sync":
            hit = any(i.op == "HMMA" and i.shape[:2] == (m, n)
                      and k % i.shape[2] == 0 and i.atype == a
                      for i in found)
        else:
            continue
        if not hit:
            problems.append(f"line {s.line}: {s.op} {s.shape}.{s.atype} "
                            f"has no instruction of its shape in the SASS")
    return len(found), problems
