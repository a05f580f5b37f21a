"""Times the port's attention backward at qwen3-1.7b's training shape on
the card.

    PYTHONPATH=src python src/repro_torch/launch/attention_bwd.py

It reaches the port only through ``repro_torch.kernels.flash_attention``
(``_prefill``, ``flash_attention_bwd``, ``bwd_launches`` where the tree
has it) and ``repro_torch.kernels.ref``, so with ``PYTHONPATH`` pointing
at another checkout's ``src`` it times that checkout: an A/B of two
trees, or of a tree and a copy with an edited ``csrc/``, runs both in
one call on one card, in turns (old, new, new, old).

Shape: a train_4k step at the per-step batch chip_smoke.py trains, q [4,
16, 4096, 128] over k, v [4, 8, 4096, 128] (GQA 2:1), causal; q, k, v
and dO N(0, 1) in bfloat16 from seed 0, o and lse from the forward
kernel. Each time is the mean of CUDA events around 5 back-to-back calls
after 2 warm-up calls: the whole backward (three launches) and, where
the tree has ``bwd_launches``, the dK/dV and dQ launches apart; SDPA's
backward on the same inputs as the yardstick. The result is checked
against ``attention_bwd_ref`` (float32) on the first sequence and a
repeat must give the same bits. Prints one JSON object.
"""
from __future__ import annotations

import json
import subprocess

import torch

SEED = 0
B, HQ, HKV, S, D = 4, 16, 8, 4096, 128
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor peak, data sheet


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


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd: needs a CUDA device")
    from repro_torch.kernels import flash_attention as FA, ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    q, do = (torch.randn((B, HQ, S, D), generator=gen,
                         device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((B, HKV, S, D), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    lse = torch.empty((B, HQ, S), dtype=torch.float32, device="cuda")
    o = FA._prefill(q, k, v, True, lse)

    def backward():
        return FA.flash_attention_bwd(q, k, v, o, do, lse, True)

    got, again = backward(), backward()
    want = ref.attention_bwd_ref(q[:1], k[:1], v[:1], o[:1], do[:1],
                                 lse[:1], True)
    pairs = S * (S + 1) // 2
    bound = 5 * 2 * D * pairs * B * HQ / BF16_FLOPS_PER_S * 1e3
    out = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "shape": {"q": list(q.shape), "k": list(k.shape), "causal": True},
           "max_abs_err": [float((g[:1].float() - w.float()).abs().max())
                           for g, w in zip(got, want)],
           "same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
           "ms": cuda_ms(backward), "bound_ms": bound}
    del got, again, want
    launches = getattr(FA, "bwd_launches", None)
    if launches is not None:
        steps = launches(q, k, v, o, do, lse, True, torch.empty_like(q),
                         torch.empty_like(k), torch.empty_like(v))
        steps["flash_attention_bwd_pre"]()
        out["dkdv_ms"] = cuda_ms(steps["flash_attention_bwd_dkdv"])
        out["dq_ms"] = cuda_ms(steps["flash_attention_bwd_dq"])
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, is_causal=True, enable_gqa=True)
    out["sdpa_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
        sdpa, (qq, kk, vv), do, retain_graph=True))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
