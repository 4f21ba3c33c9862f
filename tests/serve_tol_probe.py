"""Measure ``chip_smoke.py``'s serving errors (a) and (b) on the CPU with the
bf16 kernels' rounding emulated, at a cut given on the command line,
outside the suite.

The suite holds ``chip_smoke.SERVE_TOL`` to twice these errors at the cuts
of ``tests/test_torch_serve_kernels.CUT`` (B=2, T=512).  This script runs
the same measurement (``serve_errors``) at those cuts or at wider or
shallower ones, to see how far a cut's reading is from the card's::

    PYTHONPATH=src python -m tests.serve_tol_probe --arch qwen2-moe-a2.7b \\
        --layers 4 --d-model 2048 --heads 16 --kv-heads 16 \\
        --d-ff-expert 1408 --d-ff-shared 5632

Each field given replaces the cut's (``--d-ff-expert`` and
``--d-ff-shared`` in the MoE sub-config); the rest stay as ``CUT`` has
them.  Prints one line per arch: the config's widths, (a), (b), and the
seconds it took.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from tests import test_torch_serve_kernels as sk

FIELDS = {"layers": "n_layers", "d_model": "d_model", "heads": "n_heads",
          "kv_heads": "n_kv_heads", "d_ff": "d_ff", "vocab": "vocab"}


def cut(arch: str, args) -> object:
    """``CUT[arch]`` with the fields given in ``args`` replaced."""
    cfg = sk.CUT[arch]()
    kw = {f: getattr(args, a) for a, f in FIELDS.items()
          if getattr(args, a) is not None}
    moe = {f: getattr(args, f) for f in ("d_ff_expert", "d_ff_shared")
           if getattr(args, f) is not None}
    if moe:
        kw["moe"] = dataclasses.replace(cfg.moe, **moe)
    return cfg.variant(**kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", required=True,
                    choices=sorted(sk.CUT))
    for a in FIELDS:
        ap.add_argument("--" + a.replace("_", "-"), dest=a, type=int)
    ap.add_argument("--d-ff-expert", dest="d_ff_expert", type=int)
    ap.add_argument("--d-ff-shared", dest="d_ff_shared", type=int)
    ap.add_argument("-B", type=int, default=sk.B)
    ap.add_argument("-T", type=int, default=sk.T)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    fa.flash_attention_fwd = sk.emulated_flash
    gs.gla_scan_fwd = sk.emulated_gla
    for arch in args.arch:
        cfg = cut(arch, args)
        t0 = time.perf_counter()
        err_a, err_b = sk.serve_errors(cfg, args.B, args.T)
        widths = {f: getattr(cfg, f) for f in FIELDS.values()}
        if cfg.moe is not None:
            widths.update(d_ff_expert=cfg.moe.d_ff_expert,
                          d_ff_shared=cfg.moe.d_ff_shared)
        print(f"{arch} {widths} B={args.B} T={args.T}: (a) {err_a:.6f}, "
              f"(b) {err_b:.6f} of the largest |logit|; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
