"""Runner of the port's static-analysis gate.

Usage (from the repo root)::

    python -m repro_torch.analysis [paths...] [--json [PATH]]
        [--baseline analysis/baseline_torch.json] [--check-baseline]
        [--list-checks]

With no paths, lints every *tracked* port file: ``src/repro_torch/**/*.py``,
``src/repro_torch/kernels/csrc/*.cu``, ``examples/*_torch.py`` and
``chip_smoke.py`` (``git ls-files``; outside a git checkout, the same
globs on disk).  Checkers are scoped (see ``_in_scope``): hygiene and
isolation on every ``.py`` file, the global-generator check on
``src/repro_torch/`` only, units lint on the four modules whose names
carry unit suffixes, the CUDA checks on ``.cu`` files.

Suppression has exactly two forms, both audited:

* inline ``# repro-lint: disable=CODE <reason>`` (``// ...`` in a
  ``.cu`` file; or ``disable-next=``) on the flagged line — a missing
  reason is itself a finding (RA001);
* a committed **baseline** (``analysis/baseline_torch.json``) entry with
  a mandatory ``reason``, matched on the stable finding key
  ``(code, path, message)`` with an explicit ``count``.

``--check-baseline`` is the gate and ratchet: it fails on any new
finding *and* on any stale baseline entry (the linter no longer reports
it), so the accepted-finding count can only go down.  Exit codes:
0 clean, 1 findings/stale entries, 2 bad invocation.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.base import CODES, Finding, SourceFile
from repro_torch.analysis.cuda_checks import CudaChecker
from repro_torch.analysis.hygiene import GlobalRngChecker, HygieneChecker
from repro_torch.analysis.isolation import IsolationChecker
from repro_torch.analysis.units import UnitsChecker

DEFAULT_GLOBS = ("src/repro_torch/**/*.py", "src/repro_torch/*.py",
                 "src/repro_torch/kernels/csrc/*.cu", "examples/*_torch.py",
                 "chip_smoke.py")
DEFAULT_BASELINE = os.path.join("analysis", "baseline_torch.json")

UNITS_SCOPE = (
    "src/repro_torch/core/cost_model.py",
    "src/repro_torch/core/wire.py",
    "src/repro_torch/core/pipeline.py",
    "src/repro_torch/distrib/tiered_sync.py",
)
RNG_SCOPE = "src/repro_torch/"

_CHECKERS = (HygieneChecker(), GlobalRngChecker(), UnitsChecker(),
             IsolationChecker(), CudaChecker())


def _in_scope(checker, path: str) -> bool:
    if isinstance(checker, CudaChecker):
        return path.endswith(".cu")
    if path.endswith(".cu"):
        return False
    if isinstance(checker, UnitsChecker):
        return path in UNITS_SCOPE
    if isinstance(checker, GlobalRngChecker):
        return path.startswith(RNG_SCOPE)
    return True           # hygiene + isolation on every port .py file


def _lintable(path: str) -> bool:
    return path.endswith((".py", ".cu"))


def discover_files(root: str, paths: Sequence[str] = ()) -> List[str]:
    """Repo-relative posix paths of the files to lint."""
    if paths:
        out = []
        for p in paths:
            ap = os.path.abspath(p)
            if os.path.isdir(ap):
                for dirpath, dirnames, filenames in os.walk(ap):
                    dirnames[:] = [d for d in dirnames
                                   if d != "__pycache__"
                                   and not d.startswith(".")]
                    out += [os.path.join(dirpath, f) for f in filenames
                            if _lintable(f)]
            elif _lintable(ap):
                out.append(ap)
        return sorted(os.path.relpath(p, root).replace(os.sep, "/")
                      for p in out)
    try:
        ls = subprocess.run(
            ["git", "ls-files", "--", *DEFAULT_GLOBS], cwd=root,
            capture_output=True, text=True, check=True,
            timeout=30).stdout.split()
        if ls:
            return sorted(set(ls))
    except (OSError, subprocess.SubprocessError):
        pass
    # not a git checkout: the same globs on disk
    found = set()
    for pattern in DEFAULT_GLOBS:
        for p in glob.glob(os.path.join(root, pattern), recursive=True):
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            if "__pycache__" not in rel:
                found.add(rel)
    return sorted(found)


def lint_file(src: SourceFile) -> Tuple[List[Finding], List[Finding]]:
    """(active findings, disabled findings) for one parsed file."""
    if src.parse_error is not None:
        return [Finding("RA000", src.path, 1, 0,
                        f"file does not parse: {src.parse_error}")], []
    findings: List[Finding] = list(src.disable_findings)
    for checker in _CHECKERS:
        if _in_scope(checker, src.path):
            findings += checker.check(src)
    active = [f for f in findings if not src.disabled(f)]
    disabled = [f for f in findings if src.disabled(f)]
    active.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return active, disabled


def lint_paths(root: str, files: Sequence[str]
               ) -> Tuple[List[Finding], List[Finding]]:
    """(active, disabled) findings of the repo-relative ``files``."""
    active: List[Finding] = []
    disabled: List[Finding] = []
    for rel in files:
        full = os.path.join(root, rel)
        try:
            with open(full, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            active.append(Finding("RA000", rel, 1, 0,
                                  f"unreadable: {e}"))
            continue
        a, d = lint_file(SourceFile(rel, text))
        active += a
        disabled += d
    return active, disabled


# ---------------------------------------------------------------------------
# Baseline: accepted findings, keyed stably, each with a mandatory reason.
# ---------------------------------------------------------------------------

class BaselineError(ValueError):
    pass


def load_baseline(path: str) -> List[Dict]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", []) if isinstance(data, dict) else data
    for i, e in enumerate(entries):
        for field in ("code", "path", "message", "reason"):
            if not str(e.get(field, "")).strip():
                raise BaselineError(
                    f"baseline entry {i} is missing {field!r} — every "
                    f"accepted finding needs a stable key and a reason")
        e.setdefault("count", 1)
        if not (isinstance(e["count"], int) and e["count"] >= 1):
            raise BaselineError(f"baseline entry {i}: count must be a "
                                f"positive int")
    return entries


def apply_baseline(findings: List[Finding], entries: List[Dict]
                   ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """Split findings into (new, baselined) and return stale entries.

    An entry absorbs up to ``count`` findings with its exact
    ``(code, path, message)`` key; leftovers are new findings, and an
    entry that absorbs nothing is stale (the ratchet: prune it)."""
    budget: Dict[Tuple[str, str, str], int] = {}
    used: Dict[Tuple[str, str, str], int] = {}
    for e in entries:
        key = (e["code"], e["path"], e["message"])
        budget[key] = budget.get(key, 0) + e["count"]
        used.setdefault(key, 0)
    new: List[Finding] = []
    baselined: List[Finding] = []
    for f in findings:
        if used.get(f.key, 0) < budget.get(f.key, -1):
            used[f.key] += 1
            baselined.append(f)
        else:
            new.append(f)
    stale = [e for e in entries
             if used.get((e["code"], e["path"], e["message"]), 0) == 0]
    return new, baselined, stale


def run(root: str, paths: Sequence[str] = (),
        baseline_path: Optional[str] = None,
        check_baseline: bool = False) -> Dict:
    """Full lint pass as a JSON-ready report dict (CLI-independent so
    tests and the card's smoke run drive it directly)."""
    files = discover_files(root, paths)
    active, disabled = lint_paths(root, files)
    entries: List[Dict] = []
    baseline_missing = False
    if baseline_path:
        full = baseline_path if os.path.isabs(baseline_path) \
            else os.path.join(root, baseline_path)
        if os.path.exists(full):
            entries = load_baseline(full)
        else:
            baseline_missing = check_baseline
    new, baselined, stale = apply_baseline(active, entries)
    per_code: Dict[str, int] = {}
    for f in active:
        per_code[f.code] = per_code.get(f.code, 0) + 1
    ok = not new and not (check_baseline and (stale or baseline_missing))
    return {
        "ok": ok,
        "summary": {
            "files": len(files),
            "new": len(new), "baselined": len(baselined),
            "disabled": len(disabled), "stale_baseline": len(stale),
            "per_code": dict(sorted(per_code.items())),
        },
        "new": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in baselined],
        "disabled": [f.to_json() for f in disabled],
        "stale_baseline": stale,
        "baseline_missing": baseline_missing,
    }


def _print_report(report: Dict, check_baseline: bool) -> None:
    for f in report["new"]:
        print(f"{f['path']}:{f['line']}:{f['col']}: {f['code']} "
              f"{f['message']}")
    if check_baseline:
        for e in report["stale_baseline"]:
            print(f"STALE baseline entry: {e['code']} {e['path']} — "
                  f"{e['message']!r} is no longer reported; prune it "
                  f"(the ratchet only goes down)")
        if report["baseline_missing"]:
            print("baseline file not found — run without "
                  "--check-baseline and commit analysis/baseline_torch.json")
    s = report["summary"]
    print(f"repro-torch-lint: {s['files']} files, {s['new']} new, "
          f"{s['baselined']} baselined, {s['disabled']} inline-disabled"
          + (f", {s['stale_baseline']} stale baseline entr"
             f"{'ies' if s['stale_baseline'] != 1 else 'y'}"
             if check_baseline else ""))


def find_root(start: Optional[str] = None) -> str:
    """Repo root: nearest ancestor with .git or analysis/, else cwd."""
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(d, ".git")) \
                or os.path.isdir(os.path.join(d, "analysis")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return os.path.abspath(start or os.getcwd())
        d = parent


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: the tracked "
                         "port files)")
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="write the full report as JSON to PATH "
                         "(default stdout)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    metavar="PATH",
                    help=f"baseline file (default {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (report every finding)")
    ap.add_argument("--check-baseline", action="store_true",
                    help="the gate: fail on new findings AND on stale "
                         "baseline entries (the ratchet)")
    ap.add_argument("--list-checks", action="store_true",
                    help="print the finding-code catalog and exit")
    args = ap.parse_args(argv)

    if args.list_checks:
        for code, desc in sorted(CODES.items()):
            print(f"{code}  {desc}")
        return 0

    root = find_root()
    try:
        report = run(root, args.paths,
                     baseline_path=None if args.no_baseline
                     else args.baseline,
                     check_baseline=args.check_baseline)
    except BaselineError as e:
        print(f"repro-torch-lint: {e}", file=sys.stderr)
        return 2

    if args.json is not None:
        payload = json.dumps(report, indent=2, sort_keys=True)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w", encoding="utf-8") as f:
                f.write(payload + "\n")
            print(f"wrote {args.json}")
    if args.json != "-":
        _print_report(report, args.check_baseline)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
