"""Batched serving launcher: prefill a batch of prompts, then greedy-decode
with the KV-cache serve step.  Counterpart of ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
      --batch 4 --prompt-len 128 --gen 32

The model and its weights live on the card (``--device cuda``, the
default); without a card the launcher raises unless ``--device cpu`` is
given.  The weights are random, drawn from ``--seed``: bf16 on the card
(one leaf at a time, so a 30B model never exists in float32), float32 on
the CPU.  It prints the first call's prefill and decode times, then those
of a second, warm call.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch, smoke
from repro_torch.models import build_model
from repro_torch.models import params as pm
from repro_torch.train import make_prefill_step, make_serve_step, pad_caches


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, params, tokens, gen: int, extra=None):
    """Prefill ``tokens (B, T)``, then greedy-decode ``gen`` tokens (the
    first from the prefill's logits, the rest from ``gen - 1`` serve steps
    into caches of capacity ``T + gen``).  Returns ``(generated (B, gen)
    int32, prefill seconds, decode seconds)``, each time ending in a device
    synchronisation."""
    cfg = model.cfg
    device = tokens.device
    b, t = tokens.shape
    prefill = make_prefill_step(model, cfg)
    serve = make_serve_step(model, cfg)

    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens, **(extra or {})})
    caches = pad_caches(caches, t + gen)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, logits, caches = serve(params, caches, tok, t + i)
        out.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return torch.cat(out, dim=1), t_prefill, t_decode


def report(b: int, gen: int, t_prefill: float, t_decode: float, label: str):
    """Print one call's prefill and decode times and its decode rate."""
    steps = max(gen - 1, 1)
    print(f"[serve] {label}: prefill {t_prefill * 1e3:.1f} ms; decode {t_decode * 1e3:.1f} ms "
          f"({t_decode * 1e3 / steps:.2f} ms a step, {(gen - 1) * b / max(t_decode, 1e-9):.1f} tok/s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on the CPU")
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(smoke(cfg), moe_capacity_factor=4.0)
    model = build_model(cfg)
    gen_ = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = pm.materialize(model.spec(), gen_, device, dtype)
    b, t = args.batch, args.prompt_len

    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen_, device=device)
    extra = {}
    if cfg.family == "vlm":
        extra["visual_embeds"] = torch.randn((b, cfg.n_vis_tokens, cfg.d_model), generator=gen_,
                                             device=device) * 0.1

    print(f"[serve] arch={cfg.name} batch={b} prompt={t} gen={args.gen} device={device}")
    out, t_prefill, t_decode = generate(model, params, tokens, args.gen, extra)
    report(b, args.gen, t_prefill, t_decode, "first call")
    out, t_prefill, t_decode = generate(model, params, tokens, args.gen, extra)
    report(b, args.gen, t_prefill, t_decode, "warm")
    print("[serve] sample tokens:", out[0, :10].tolist())
    return out


if __name__ == "__main__":
    main()
