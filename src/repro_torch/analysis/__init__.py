"""repro_torch.analysis — the port's static-analysis gate (DESIGN.md §14).

The counterpart of the reference's ``repro.analysis``, with its own
runner and baseline (``analysis/baseline_torch.json``), over the port's
files: ``src/repro_torch/`` (its ``.py`` files and the CUDA sources
under ``kernels/csrc/``), ``examples/*_torch.py`` and ``chip_smoke.py``.
Run ``python -m repro_torch.analysis --check-baseline`` from the repo
root; ``--list-checks`` prints the catalog.

The codes keep the reference's numbers wherever the bug class is the
same: RA000/RA001 (parse, disable comments), RA101–RA105
(:mod:`~repro_torch.analysis.hygiene`: graphs and libraries rebuilt in
loops, id-keyed caches, global-generator draws, unhashable cache
arguments), RA301/RA302 (:mod:`~repro_torch.analysis.units`, a copy of
the reference's), RA401 (:mod:`~repro_torch.analysis.isolation`: no
import of the reference or JAX) and RA501–RA503
(:mod:`~repro_torch.analysis.cuda_checks`: grid arity, block coverage and
f32 accumulation of the CUDA kernels).  RA201 has no counterpart: eager
PyTorch donates no buffer, so there is no read after donation to find.

The package imports nothing of ``repro`` or ``jax``: the infrastructure
it shares with the reference is a copy.
"""
from repro_torch.analysis.base import CODES, Finding, SourceFile

__all__ = ["CODES", "Finding", "SourceFile", "lint_file", "lint_paths",
           "run"]


def __getattr__(name):
    # Lazy: importing the runner here would shadow the
    # ``python -m repro_torch.analysis.lint`` entry point (runpy warning).
    if name in ("lint_file", "lint_paths", "run"):
        from repro_torch.analysis import lint
        return getattr(lint, name)
    raise AttributeError(name)
