"""Prints a hash of the outputs of the prefill attention kernels (bf16
and float32, serving), the decode attention kernel, the FM forward
kernel, the attention backward at d 64, 128 and 256 (bf16, and float32
where the tree has its kernels) and the MoE layer on seeded inputs, on
the card: a check that an edit to code they share (``csrc/mbarrier.cuh``,
``csrc/wgmma.cuh``, ``csrc/tf32x3.cuh``, the backward's wrapper and
helpers, ``models/moe.py``) left their bits unchanged, and that the
d = 256 backwards and the float32 backward at every d give the same bits
when repeated.

    PYTHONPATH=src python src/repro_torch/launch/kernel_bits.py
    python src/repro_torch/launch/kernel_bits.py --trees build/parent/src src

It reaches the port only through ``repro_torch.kernels.flash_attention``
(``_prefill``, ``flash_decode``, ``flash_attention_bwd``) and
``repro_torch.kernels.fm_interaction``
(``fm_interaction``), so with ``PYTHONPATH`` pointing at another
checkout's ``src`` it hashes that checkout's kernels; ``--trees A B`` runs
it for both in child processes and prints, beside each tree's hashes,
whether every hash the two share agrees. Inputs, from seed 0 on the
card: the prefill (``_prefill`` without an lse, the serving entries) at
qwen3-1.7b's served shape, q [8, 16, 2048, 128] over 8 KV heads, causal,
in bfloat16 and float32; decode over
[8, hkv, 2112, d] caches with ragged lengths at (hq, hkv, d) = (16, 8,
128) (qwen3-1.7b), (24, 8, 64) (granite-moe-3b-a800m) and (32, 2, 128)
(chatglm3-6b), in bfloat16 and float32; the FM forward at the
serve_bulk shape (per-row v [262144, 39, 10], x the stride-0 ones) and
with one shared v [26, 16] under strided x [4096, 26]; the attention
backward (``flash_attention_bwd``: dq, dk, dv) at [1, 16, 4096, d],
causal, over 8 KV heads at d 64 and 128 (granite's and qwen3's training
shapes) and over 16 at d 256 (gemma-7b's), the latter twice (the
``repeat`` key), in bfloat16; ``moe_ffn``'s output and aux loss for
granite-moe-3b-a800m's layer (d 1536, 40 experts of 512, top-8) on 8 x
2048 bf16 tokens in 32 groups; last, where the tree has the float32
backward (its launch keys in ``LAUNCHES``), the backward's shapes again
in float32, each twice, with the lse of the float32 forward's training
entry (drawn after every other input, so a tree without them hashes the
same inputs for the rest), and that entry's output and lse at each shape
and dtype. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import torch

DECODE = ((16, 8, 128), (24, 8, 64), (32, 2, 128))


def digest(t: torch.Tensor) -> str:
    raw = t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def backward_hashes(FA, gen, dt, tag: str) -> dict:
    """The attention backward's (dq, dk, dv) hashes at [1, 16, 4096, d],
    causal, d 64 and 128 over 8 KV heads and d 256 over 16 (twice; in
    float32 each d twice), the forward's training entry (its output and
    lse), and whether it gave the serving entry's output bits."""
    out = {}
    for d, hkv in ((64, 8), (128, 8), (256, 16)):
        q, do = (torch.randn((1, 16, 4096, d), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((1, hkv, 4096, d), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        lse = torch.empty((1, 16, 4096), dtype=torch.float32, device="cuda")
        o = FA._prefill(q, k, v, True, lse)
        out[f"forward{tag} d{d} with lse as served"] = str(
            torch.equal(o, FA._prefill(q, k, v, True, None)))
        out[f"forward{tag} d{d} with lse"] = digest(o) + digest(lse)
        grads = FA.flash_attention_bwd(q, k, v, o, do, lse, True)
        out[f"attention backward{tag} d{d}"] = "".join(
            digest(g) for g in grads)
        if d == 256 or dt == torch.float32:
            grads = FA.flash_attention_bwd(q, k, v, o, do, lse, True)
            out[f"attention backward{tag} d{d} repeat"] = "".join(
                digest(g) for g in grads)
    return out


def hashes() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bits: needs a CUDA device")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fm_interaction as FI
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn((8, 16, 2048, 128), generator=gen,
                        device="cuda").to(dt)
        k, v = (torch.randn((8, 8, 2048, 128), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        out[f"prefill {str(dt).split('.')[-1]} 16:8 d128"] = digest(
            FA._prefill(q, k, v, True, None))
        del q, k, v
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        for hq, hkv, d in DECODE:
            q = torch.randn((8, hq, d), generator=gen, device="cuda").to(dt)
            k, v = (torch.randn((8, hkv, 2112, d), generator=gen,
                                device="cuda").to(dt) for _ in range(2))
            kv_len = torch.randint(1, 2113, (8,), generator=gen,
                                   device="cuda").int()
            out[f"decode {name} {hq}:{hkv} d{d}"] = digest(
                FA.flash_decode(q, k, v, kv_len))
        x = torch.ones((1, 1), device="cuda").expand(262144, 39).to(dt)
        v = (torch.randn((262144, 39, 10), generator=gen, device="cuda")
             * 0.01).to(dt)
        out[f"fm forward {name} per-row"] = digest(FI.fm_interaction(x, v))
        x = torch.randn((26, 4096), generator=gen, device="cuda").to(dt).t()
        v = torch.randn((26, 16), generator=gen, device="cuda").to(dt)
        out[f"fm forward {name} shared"] = digest(FI.fm_interaction(x, v))
    out.update(backward_hashes(FA, gen, torch.bfloat16, ""))
    from repro_torch.models import moe as M
    cfg = M.MoEConfig(40, 8, 512)
    params = M.init_moe(cfg, 1536, torch.bfloat16, gen)
    x = torch.randn((8 * 2048, 1536), generator=gen,
                    device="cuda").bfloat16()
    y, aux = M.moe_ffn(params, x, cfg, groups=32)
    out["moe_ffn granite-3b layer"] = digest(y) + digest(aux)
    if "flash_attention_bwd_tf32_dkdv" in FA.LAUNCHES:
        out.update(backward_hashes(FA, gen, torch.float32, " float32"))
    return {"tree": FI.__file__, "hashes": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"),
                    help="two trees' src directories, hashed in child "
                         "processes and compared")
    args = ap.parse_args(argv)
    if not args.trees:
        out = hashes()
    else:
        runs = []
        for src in args.trees:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
            run = subprocess.run([sys.executable, os.path.abspath(__file__)],
                                 env=env, stdout=subprocess.PIPE, text=True,
                                 check=True)
            runs.append(json.loads(run.stdout.strip().splitlines()[-1]))
        out = {"trees": runs, "identical": {
            key: runs[0]["hashes"][key] == runs[1]["hashes"][key]
            for key in runs[0]["hashes"] if key in runs[1]["hashes"]}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
