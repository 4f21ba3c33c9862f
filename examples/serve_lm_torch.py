"""Batched serving with the PyTorch port: prefill a prompt batch, decode
new tokens with the KV cache / recurrent state, report throughput.
``--arch`` selects any of the ten architectures' *smoke* config, or with
``--full`` its published one (seeded random weights either way); an
encoder-decoder (whisper-base) also gets seeded frame embeddings (the
stubbed audio frontend's output): 1,500 with ``--full``, its 30 s
window, else as many as the prompt's tokens.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen2.5-3b \\
        --new 32 --device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --arch whisper-base \\
        --device cpu

Without ``--device`` it runs on ``cuda`` and raises when there is none.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models.lm.model import build_model
from repro_torch.serve.engine import generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke twin")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve a "
                           "smoke config on the CPU")
    spec = get_arch(args.arch)
    cfg = spec.lm if args.full else spec.smoke
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    B, T = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen,
                                     device=device)}
    if cfg.n_frontend_tokens > 0:
        P = min(cfg.n_frontend_tokens, T // 2)
        batch["tokens"] = batch["tokens"][:, :T - P]
        batch["embeds"] = torch.randn((B, P, cfg.d_model), generator=gen,
                                      device=device)
    if cfg.family == "encdec":
        frames = 1500 if args.full else T
        batch["frames"] = torch.randn((B, frames, cfg.d_model),
                                      generator=gen, device=device).to(
                                          cfg.dtype)

    t0 = time.perf_counter()
    out = generate(model, params, batch, max_len=T + args.new,
                   n_new=args.new, generator=gen,
                   temperature=args.temperature)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    kind = "published" if args.full else "smoke"
    print(f"arch={args.arch} ({kind} config, family={cfg.family}) on "
          f"{device}")
    print(f"generated {B}x{args.new} tokens in {dt:.2f}s "
          f"({B * args.new / dt:.1f} tok/s incl. prefill)")
    print("sample token ids:", out.tokens[0, :16].tolist())
    return {"tokens": out.tokens, "seconds": dt}


if __name__ == "__main__":
    main()
