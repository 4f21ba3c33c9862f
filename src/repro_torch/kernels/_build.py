"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled on first use for ``sm_90a`` into
``build/repro_torch/<name>-<hash>/`` at the repository root (the hash
covers the source and the flags, so an edited source rebuilds) and
loaded with :mod:`ctypes`.  Nothing here runs at import time.

:func:`build_all` starts one ``nvcc`` per source at once, so a caller
that needs every kernel pays for the slowest build, not their sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built on the machine with the card (set CUDA_HOME or "
                       "put nvcc on PATH)")


def sources() -> List[str]:
    """Names of the kernels under ``csrc/`` (``<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{key}" / f"lib{name}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start compiling ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    """Wait for ``proc``, publish its library atomically, return the
    compiler's output (kept beside the library as ``nvcc.log``)."""
    out = _target(name)
    log = out.parent / "nvcc.log"
    if proc is None:
        return log.read_text() if log.exists() else ""
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return text


def build_all() -> Dict[str, dict]:
    """Build every kernel in parallel.  Returns ``{name: {"seconds",
    "log"}}`` with each build's wall time (0 when already built) and
    ``nvcc``'s output (registers, shared memory and spills per kernel)."""
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in sources()}
    report = {}
    for n, p in procs.items():
        text = _finish(n, p)
        report[n] = {"seconds": 0.0 if p is None
                     else time.perf_counter() - t0, "log": text}
    return report


def patched_source(name: str, patches) -> str:
    """``csrc/<name>.cu`` with each ``(old, new)`` text patch applied; each
    ``old`` must occur exactly once."""
    src = (CSRC / f"{name}.cu").read_text()
    for old, new in patches:
        if src.count(old) != 1:
            raise ValueError(f"{name}: patch anchor found {src.count(old)} "
                             f"times: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(name: str, sources: Dict[str, str]
                   ) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile each ``{variant: source text}`` of kernel ``name`` at once
    (one ``nvcc`` each) under ``build/repro_torch/variants/`` and load
    them.  Returns each variant's library and ``nvcc``'s output."""
    procs, libs = {}, {}
    for variant, src in sources.items():
        key = hashlib.sha256((src + " ".join(NVCC_FLAGS)).encode())
        out = BUILD_ROOT / "variants" / \
            f"{name}-{variant}-{key.hexdigest()[:16]}"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{name}.cu").write_text(src)
        lib = out / f"lib{name}.so"
        procs[variant] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for variant, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name} variant {variant}:\n"
                               f"{text}")
        # repro-lint: disable-next=RA101 one load per variant: each pass loads another source's library, once
        libs[variant] = (ctypes.CDLL(str(lib)), text)
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
