"""Batched LM serving: prefill + greedy decode loop, after
``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 8 --prompt-len 2048 --gen-tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --smoke --device cpu

Requests are grouped into one fixed batch; the KV cache, sized to
prompt_len + gen_tokens, is the incrementally maintained arrangement,
and each decode step is a one-token delta against it. Unlike the
reference, the full config runs too, with random weights drawn
from ``--seed`` on the device (no checkpoint is loaded).

The run synchronizes the device once after the prefill, so that
``prefill_s`` is the prefill's time and not its enqueue, and once per
decode step (as the reference's ``block_until_ready``), and nowhere
else.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.engine.observe import MetricsRegistry
from repro_torch.models import transformer as T
from repro_torch.models.common import resolve_device


class Generation(NamedTuple):
    tokens: np.ndarray          # [B, gen_tokens] greedy tokens
    logits: torch.Tensor        # [B, V] logits of the last decode step
    cache: T.KVCache            # capacity prompt_len + gen_tokens
    registry: MetricsRegistry   # serve.prefill_s, serve.decode_step_s
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: T.Transformer, prompts, gen_tokens: int) -> Generation:
    """Prefill ``prompts`` [B, prompt_len] into a cache of capacity
    prompt_len + gen_tokens, then ``gen_tokens`` greedy decode steps. The
    tokens are the prefill's argmax followed by each step's but the last
    (the reference's loop)."""
    device = model.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                              device=device)
    reg = MetricsRegistry()
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts,
                                  capacity=prompts.shape[1] + gen_tokens)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    reg.gauge("serve.prefill_s", t_prefill)

    generated = []
    t0 = time.perf_counter()
    for _ in range(gen_tokens):
        generated.append(tok[:, 0])
        t_step = time.perf_counter()
        logits, cache = model.decode_step(tok, cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        _sync(device)
        reg.observe("serve.decode_step_s", time.perf_counter() - t_step)
    t_decode = time.perf_counter() - t0
    gen = (torch.stack(generated, dim=1).cpu().numpy() if generated
           else np.zeros((prompts.shape[0], 0), np.int32))
    return Generation(gen, logits, cache, reg, t_prefill, t_decode)


def summary(g: Generation, requests: int, gen_tokens: int) -> dict:
    """The dict the reference's serve loop prints."""
    steps = g.registry.percentiles("serve.decode_step_s") or {}
    return {
        "requests": requests,
        "prefill_s": round(g.prefill_s, 3),
        "decode_s": round(g.decode_s, 3),
        "decode_step_p50_ms": round(steps.get("p50", 0.0) * 1e3, 2),
        "decode_step_p99_ms": round(steps.get("p99", 0.0) * 1e3, 2),
        "tokens_per_s": round(
            requests * gen_tokens / max(g.decode_s, 1e-9), 1),
        "sample_output": g.tokens[0][:8].tolist(),
    }


def build(arch_name: str, smoke: bool, device: str, seed: int):
    """(model, cfg) with weights drawn from ``seed`` on ``device``."""
    from repro_torch.configs import get_arch
    arch = get_arch(arch_name)
    cfg = arch.smoke_cfg if smoke else arch.cfg
    dev = resolve_device(device, "Transformer")
    gen = torch.Generator(dev).manual_seed(seed)
    return T.Transformer(cfg, device=dev, generator=gen), cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted for the reference's interface; "
                         "decoding is greedy")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the prompts")
    args = ap.parse_args(argv)

    model, cfg = build(args.arch, args.smoke, args.device, args.seed)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(
        0, cfg.vocab, size=(args.requests, args.prompt_len))
    g = generate(model, prompts, args.gen_tokens)
    out = summary(g, args.requests, args.gen_tokens)
    print(out)
    return out


if __name__ == "__main__":
    main()
