"""Measure a fleet stack's int8-vs-none per-token loss gap and its
precision floor on the CPU, in the JAX package and in the port, outside
the suite.

``chip_smoke.py`` holds fleet-xlstm's gap on the card to the larger of
``E2E_LOSS_GAP`` and its precision floor: the gap between the same
``wire="none"`` steps in bf16 and in f32 from the same init.  This
script runs that measurement at a cut given on the command line, on the
card's M=4 plan shape (``tests/test_torch_int8_gap.GapRun``)::

    PYTHONPATH=src python -m tests.int8_gap_probe --family xlstm \\
        --layers 4 --seq 128 --batch 8 --steps 6 --packages jax,torch

Prints each (package, dtype, wire)'s per-token losses and the seconds
they took, then per package and dtype the int8-vs-none gaps, and with
both dtypes the floor.
"""
from __future__ import annotations

import argparse
import time

import torch

import chip_smoke
from tests.test_torch_int8_gap import GapRun


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", default="xlstm",
                    help="fig_lm_fleet config: gla, moe or xlstm")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=chip_smoke.LM_LR)
    ap.add_argument("--steps", type=int, default=chip_smoke.LM_STEPS)
    ap.add_argument("--dtypes", default="f32,bf16")
    ap.add_argument("--packages", default="jax,torch")
    ap.add_argument("--threads", type=int, default=4,
                    help="the port's intra-op threads")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    run = GapRun(args.family, args.layers, args.seq, args.batch, args.lr)
    dtypes, packages = args.dtypes.split(","), args.packages.split(",")
    got = {}
    for dtype in dtypes:
        for wire in ("none", "int8"):
            for pkg in packages:
                t0 = time.perf_counter()
                got[pkg, dtype, wire] = run.losses(pkg, dtype, wire,
                                                   args.steps)
                print(pkg, dtype, wire, got[pkg, dtype, wire],
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    for pkg in packages:
        for dtype in dtypes:
            print(pkg, dtype, "int8-vs-none gaps",
                  [abs(a - b) for a, b in zip(got[pkg, dtype, "int8"],
                                              got[pkg, dtype, "none"])])
        if {"f32", "bf16"} <= set(dtypes):
            print(pkg, "precision floor (bf16-vs-f32, none)",
                  [abs(a - b) for a, b in zip(got[pkg, "bf16", "none"],
                                              got[pkg, "f32", "none"])])
    return got


if __name__ == "__main__":
    main()
