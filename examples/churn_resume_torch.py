"""Elastic fleet + crash-safe resume, end to end through
``repro_torch.api`` (DESIGN.md §10).  The twin of
``examples/churn_resume.py``.

A heterogeneous M-device star fleet trains a small CNN while a
deterministic Poisson churn trace joins, removes, crashes, and fades
devices mid-run; every membership change remaps the live schedule onto
the survivors and warm-starts the re-solve.  The run is then killed
mid-flight with an injected failure and resumed from its atomic
checkpoint — and the resumed run must be *bitwise* equal to the
uninterrupted one (final params, history tail, simulated wall clock).

    PYTHONPATH=src python examples/churn_resume_torch.py --device cpu \\
        [--steps 24] [--m 3] [--fail-at 14] [--ckpt-dir DIR]

Without ``--device`` it runs on ``cuda`` and raises when there is none.
"""
import argparse
import tempfile

import torch

from repro_torch.api import Fleet, plan
from repro_torch.core.churn import poisson_trace
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.models.cnn import lenet5
from repro_torch.train.loop import InjectedFailure


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--m", type=int, default=3,
                    help="initial number of devices (star topology)")
    ap.add_argument("--fail-at", type=int, default=14)
    ap.add_argument("--ckpt-every", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint store (default: a fresh tmpdir)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    model = lenet5()
    spec = Fleet.from_table2(model="lenet5", m=args.m, topology="star")
    fleet = Fleet.from_profile(spec.profile_for(model), spec.network())
    prof = fleet.profile_for(model)
    data = SyntheticImages(model.input_shape, model.num_classes,
                           args.batch, seed=0)
    trace = poisson_trace(prof.worker_names[:-2], args.steps, seed=2,
                          join_rate=0.1, leave_rate=0.08,
                          crash_rate=0.06, degrade_rate=0.1)
    print(f"fleet: {fleet.describe()}")
    print("churn trace:")
    for e in trace.events:
        print(f"  step {e.step:>3}: {type(e).__name__} {e.name}")

    # --- uninterrupted reference run (no checkpointing) -----------------
    ref = plan(model, fleet, args.batch).train(
        data, steps=args.steps, churn=trace, seed=0, device=args.device)
    for c in ref["churn_log"]:
        print(f"  step {c['step']:>3}: {','.join(c['events'])} -> M={c['m']}"
              f" re-solved in {c['resolve_s']*1e3:.0f}ms "
              f"({c['n_pruned']}/{c['n_candidates']} lanes pruned, "
              f"warm={c['warm']})")

    # --- kill mid-run, then resume from the checkpoint ------------------
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="hiertrain_ckpt_")
    kw = dict(steps=args.steps, churn=trace, seed=0, ckpt_dir=ckpt_dir,
              ckpt_every=args.ckpt_every, device=args.device)
    try:
        plan(model, fleet, args.batch).train(data, fail_at=args.fail_at,
                                             **kw)
        raise SystemExit("injected failure never fired — check --fail-at")
    except InjectedFailure as e:
        print(f"\nkilled: {e}")
    resumed = plan(model, fleet, args.batch).train(data, **kw)
    print(f"resumed from step {resumed['resumed_from']} "
          f"(checkpoints in {ckpt_dir})")

    # --- the resumed run must be bitwise equal --------------------------
    for a, b in zip(ref["params"], resumed["params"]):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise SystemExit(f"resumed params differ at {k}")
    assert resumed["wall"] == ref["wall"], (resumed["wall"], ref["wall"])
    tail = [h for h in ref["history"] if h["step"] > resumed["resumed_from"]]
    assert [h["loss"] for h in tail] == \
        [h["loss"] for h in resumed["history"]]
    print(f"bitwise resume OK: loss {ref['history'][-1]['loss']:.4f}, "
          f"simulated wall {ref['wall']:.2f}s, "
          f"{len(ref['churn_log'])} churn re-solves")
    return resumed


if __name__ == "__main__":
    main()
