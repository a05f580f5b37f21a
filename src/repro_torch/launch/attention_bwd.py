"""Times the port's attention backward at a training shape on the card:
qwen3-1.7b's (the default) or gemma-7b's, in bfloat16 (the default) or
float32.

    PYTHONPATH=src python src/repro_torch/launch/attention_bwd.py
    PYTHONPATH=src python src/repro_torch/launch/attention_bwd.py --shape gemma
    PYTHONPATH=src python src/repro_torch/launch/attention_bwd.py --dtype float32

It reaches the port only through ``repro_torch.kernels.flash_attention``
(``_prefill``, ``flash_attention_bwd``, ``bwd_launches`` where the tree
has it) and ``repro_torch.kernels.ref``, so with ``PYTHONPATH`` pointing
at another checkout's ``src`` it times that checkout: an A/B of two
trees, or of a tree and a copy with an edited ``csrc/``, runs both in
one call on one card, in turns (old, new, new, old).

Shapes: a train_4k step at the per-step batch chip_smoke.py trains,
causal: ``qwen3``, q [4, 16, 4096, 128] over k, v [4, 8, 4096, 128] (GQA
2:1), in float32 q [2, 16, 4096, 128] (the float32 step's batch of 2);
``gemma``, q [1, 16, 4096, 256] over 16 KV heads (the d = 256 kernels).
q, k, v and dO N(0, 1) in the dtype from seed 0, o and lse from the
forward kernel. The bound counts five products of 2 d flops per visible
pair, at 989 TFLOP/s for bfloat16 and three times over at 495 (3xTF32)
for float32. Each time is the mean of CUDA events around 5
back-to-back calls after 2 warm-up calls: the whole backward (three
launches) and, where the tree has ``bwd_launches``, its dK/dV and dQ
launches apart (the second and third of its dict, whatever their keys);
SDPA's backward on the same inputs as the yardstick. The result is
compared with ``attention_bwd_ref`` (float32 for bfloat16 inputs,
float64 for float32 ones) on the first sequence (the largest absolute
errors are printed) and a repeat must give the same bits. Prints one
JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

SEED = 0
# (b, hq, hkv, s, d) of each shape
SHAPES = {"qwen3": (4, 16, 8, 4096, 128), "gemma": (1, 16, 16, 4096, 256)}
F32_BATCH = {"qwen3": 2}     # the float32 step's per-step batch
# H100 SXM dense tensor peaks, data sheet: bf16, and TF32 taken three times
FLOPS_PER_S = {"bfloat16": 989e12, "float32": 495e12 / 3}


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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", choices=sorted(SHAPES), default="qwen3")
    ap.add_argument("--dtype", choices=sorted(FLOPS_PER_S),
                    default="bfloat16")
    args = ap.parse_args(argv)
    B, HQ, HKV, S, D = SHAPES[args.shape]
    dtype = getattr(torch, args.dtype)
    if dtype == torch.float32:
        B = F32_BATCH.get(args.shape, B)
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd: needs a CUDA device")
    from repro_torch.kernels import flash_attention as FA, ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    q, do = (torch.randn((B, HQ, S, D), generator=gen,
                         device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((B, HKV, S, D), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device="cuda")
    o = FA._prefill(q, k, v, True, lse)

    def backward():
        return FA.flash_attention_bwd(q, k, v, o, do, lse, True)

    got, again = backward(), backward()
    plain = torch.float64 if dtype == torch.float32 else dtype
    want = ref.attention_bwd_ref(*(t[:1].to(plain) for t in (q, k, v, o,
                                                              do)),
                                 lse[:1], True)
    pairs = S * (S + 1) // 2
    bound = 5 * 2 * D * pairs * B * HQ / FLOPS_PER_S[args.dtype] * 1e3
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "shape": {"name": args.shape, "q": list(q.shape),
                     "k": list(k.shape), "causal": True,
                     "dtype": args.dtype},
           "max_abs_err": [float((g[:1].double() - w.double()).abs().max())
                           for g, w in zip(got, want)],
           "same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
           "ms": cuda_ms(backward), "bound_ms": bound}
    del got, again, want
    launches = getattr(FA, "bwd_launches", None)
    if launches is not None:
        steps = launches(q, k, v, o, do, lse, True, torch.empty_like(q),
                         torch.empty_like(k), torch.empty_like(v))
        pre, dkdv, dq = steps.values()
        out["timed"] = list(steps)[1:]
        pre()
        out["dkdv_ms"] = cuda_ms(dkdv)
        out["dq_ms"] = cuda_ms(dq)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True, enable_gqa=True)
    out["sdpa_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qq, kk, vv), do, retain_graph=True))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
