"""Times the port's float32 prefill attention at qwen3-1.7b's shapes on
the card, and qwen3-1.7b served in float32 at full depth.

    PYTHONPATH=src python src/repro_torch/launch/prefill_attention.py

It reaches the port only through ``repro_torch.kernels.flash_attention``
(``flash_attention``, ``flash_attention_plain``, ``prefill_kernel``),
``repro_torch.configs.get_arch``, ``repro_torch.models.transformer`` and
``repro_torch.launch.serve.generate``, so with ``PYTHONPATH`` pointing at
another checkout's ``src`` it times that checkout: an A/B of two trees
runs both in one call on one card, in turns (old, new, new, old).

Kernel: q [8, 16, 2048, 128] over k, v [8, 8, 2048, 128] (8 requests of
2048 tokens) and q [1, 16, 4096, 128] over [1, 8, 4096, 128], causal,
N(0, 1) float32 inputs from seed 0; each time is the mean of CUDA events
around 5 back-to-back calls after 2 warm-up calls, beside the largest
difference from the plain version. Serve: the float32 serve phase of
chip_smoke.py (28 layers, random weights from seed 0, 8 prompts of 2048
random tokens, 8 greedy tokens) after a short warm-up, twice; each run's
prefill seconds and decode step p50. Prints one JSON object.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess

import numpy as np
import torch

SEED = 0
SHAPES = {"served": ((8, 16, 2048, 128), (8, 8, 2048, 128)),
          "4096": ((1, 16, 4096, 128), (1, 8, 4096, 128))}
# chip_smoke.py's float32 serve: layers, requests, prompt tokens, steps
LAYERS, REQUESTS, PROMPT_LEN, GEN_TOKENS = 28, 8, 2048, 8
SERVE_RUNS = 2


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(FA) -> dict:
    gen = torch.Generator("cuda").manual_seed(SEED)
    out = {}
    for label, (qs, ks) in SHAPES.items():
        q = torch.randn(qs, generator=gen, device="cuda")
        k = torch.randn(ks, generator=gen, device="cuda")
        v = torch.randn(ks, generator=gen, device="cuda")
        err = float((FA.flash_attention(q, k, v, True)
                     - FA.flash_attention_plain(q, k, v, True)).abs().max())
        out[label] = {"ms": cuda_ms(lambda: FA.flash_attention(q, k, v,
                                                               True)),
                      "max_abs_err": err}
        del q, k, v
        torch.cuda.empty_cache()
    return out


def serve_f32() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").cfg, n_layers=LAYERS,
                              dtype="float32")
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(REQUESTS, PROMPT_LEN))
    serve.generate(model, prompts[:, :64], 2)          # warm-up
    out = {"layers": LAYERS, "requests": REQUESTS, "prompt_len": PROMPT_LEN,
           "gen_tokens": GEN_TOKENS, "prefill_s": [],
           "decode_step_p50_ms": []}
    for _ in range(SERVE_RUNS):
        g = serve.generate(model, prompts, GEN_TOKENS)
        steps = g.registry.percentiles("serve.decode_step_s")
        out["prefill_s"].append(g.prefill_s)
        out["decode_step_p50_ms"].append(steps["p50"] * 1e3)
        out["tokens"] = g.tokens[:, 0].tolist()
        del g
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("prefill_attention: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import flash_attention as FA
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "kernel": FA.prefill_kernel(torch.float32)}
    out.update(kernel_times(FA))
    out["serve"] = serve_f32()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
