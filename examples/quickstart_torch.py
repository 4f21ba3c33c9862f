"""Quickstart for the PyTorch/CUDA port: HierTrain end to end through
``repro_torch.api``.

LeNet-5 (or AlexNet) on synthetic class-conditional images on the
paper's mobile-edge-cloud testbed: build a ``Fleet``, ``plan()`` the
Algorithm-1 schedule, then ``Plan.train`` it — the straggler-aware loop,
here with the worker that holds TASK O slowed 8x for a stretch, so the
online re-scheduler moves work off it and back.  Runs on the card by
default; a machine without one needs ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        [--steps 30] [--m 2] [--model alexnet] [--wire int8]
"""
import argparse
import tempfile

from repro_torch.api import Fleet, plan
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.models import cnn


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--m", type=int, default=1,
                    help="number of devices (1 = the paper's triple)")
    ap.add_argument("--model", choices=("lenet5", "alexnet"),
                    default="lenet5")
    ap.add_argument("--wire", choices=("none", "int8"), default="none")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()

    model = getattr(cnn, args.model)()
    fleet = Fleet.from_table2(model=args.model, m=args.m, wire=args.wire)
    p = plan(model, fleet, args.batch)                 # Algorithm 1
    print(f"plan: {p.schedule.describe()}  T_total={p.t_total:.6g}s "
          f"T_period={p.t_period:.6g}s")

    data = SyntheticImages(model.input_shape, model.num_classes,
                           args.batch, seed=0)

    straggler = p.schedule.worker_o

    def slowdown(step):               # TASK O's worker straggles mid-run
        return {straggler: 8.0} if args.steps // 3 <= step < \
            2 * args.steps // 3 else {}

    with tempfile.TemporaryDirectory() as ckpt:
        out = p.train(data, steps=args.steps, lr=args.lr, resched_every=5,
                      ema=0.8, worker_slowdown=slowdown, log=print,
                      ckpt_dir=ckpt, ckpt_every=10, device=args.device)
    hist = out["history"]
    changes = sum(a["sched"] != b["sched"] for a, b in zip(hist, hist[1:]))
    print(f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
          f"schedule changed {changes} times; simulated wall "
          f"{out['wall']:.4f}s; final {out['final_schedule'].describe()}")


if __name__ == "__main__":
    main()
