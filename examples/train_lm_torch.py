"""End-to-end LM training with the PyTorch port: a ~100M-class dense
transformer on the synthetic token stream, with checkpoint/restart and
(optional) failure injection.  The twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 \\
        --fail-at 30 --device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --resume \\
        --device cpu

``--hier`` instead trains the same config *hierarchically* across the LM
mobile-edge-cloud fleet through the ``repro_torch.api`` front door: plan
the Algorithm-1 cut/split, print the breakdown, run the straggler-aware
hybrid-SGD loop:

    PYTHONPATH=src python examples/train_lm_torch.py --hier --steps 20 \\
        --devices 2 --device cpu

~100M params needs --size full; the default "small" config (~20M)
exercises the same code.  Without ``--device`` it runs on ``cuda`` and
raises when there is none.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import make_lm_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.lm.model import LMConfig, build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.loop import LoopConfig, run_train_loop
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import leaves

SIZES = {
    "small": LMConfig("lm-20m", "dense", n_layers=4, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=1024, vocab=32_000,
                      dtype=torch.float32),
    "full": LMConfig("lm-110m", "dense", n_layers=10, d_model=640,
                     n_heads=10, n_kv_heads=5, d_ff=2560, vocab=32_000,
                     dtype=torch.float32),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", choices=SIZES, default="small")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="(restart picks up the latest checkpoint "
                    "automatically; flag is informational)")
    ap.add_argument("--hier", action="store_true",
                    help="train hierarchically across the LM fleet via "
                    "repro_torch.api instead of the single-process loop")
    ap.add_argument("--devices", type=int, default=1,
                    help="fleet device count for --hier")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = SIZES[args.size]
    device = resolve_device(args.device)
    if args.hier:
        return hier_main(cfg, args, device)
    model = build_model(cfg)
    opt = get_optimizer("adamw", lr=3e-4, weight_decay=0.0)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(model, opt, gen, device)
    n = sum(t.numel() for t in leaves(state["params"]))
    print(f"model {cfg.name}: {n/1e6:.1f}M params")

    shape = ShapeSpec("example", args.seq, args.batch, "train")
    batch_fn = make_lm_batch_fn(cfg, shape, seed=0)
    out = run_train_loop(
        LoopConfig(total_steps=args.steps, ckpt_every=20,
                   ckpt_dir=args.ckpt_dir, log_every=10,
                   fail_at=args.fail_at),
        state, make_train_step(model, opt), batch_fn)
    if out["resumed_from"] is not None:
        print(f"(resumed from checkpoint at step {out['resumed_from']})")
    hist = out["history"]
    if len(hist) >= 2:
        print(f"loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return out


def hier_main(cfg, args, device) -> dict:
    """Plan and run hierarchical LM training through repro_torch.api."""
    from repro_torch.api import Fleet, plan
    from repro_torch.models.lm.layerstack import lm_layerstack

    stack = lm_layerstack(cfg, seq_len=args.seq)
    fleet = Fleet.lm_default(m=args.devices)
    p = plan(stack, fleet, args.batch)
    print(p.explain())

    class TokenData:
        """Stateless batch source in the loop's {"x", "labels"} shape."""

        def batch(self, step):
            gen = torch.Generator().manual_seed(step)
            x, labels = stack.dummy_batch(gen, args.batch)
            return {"x": x, "labels": labels}

    out = p.train(TokenData(), steps=args.steps, lr=0.05,
                  log=lambda s: print(s), device=device)
    hist = out["history"]
    print(f"hier loss: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"(modeled fleet wall clock {out['wall']:.1f}s, final schedule "
          f"{out['final_schedule'].describe()})")
    return out


if __name__ == "__main__":
    main()
