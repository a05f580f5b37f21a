"""Prints a hash of the outputs of the decode attention kernel and the FM
forward kernel on seeded inputs, on the card: a check that an edit to
code they share (``csrc/mbarrier.cuh``) left their bits unchanged.

    PYTHONPATH=src python src/repro_torch/launch/kernel_bits.py
    python src/repro_torch/launch/kernel_bits.py --trees build/parent/src src

It reaches the port only through ``repro_torch.kernels.flash_attention``
(``flash_decode``) and ``repro_torch.kernels.fm_interaction``
(``fm_interaction``), so with ``PYTHONPATH`` pointing at another
checkout's ``src`` it hashes that checkout's kernels; ``--trees A B`` runs
it for both in child processes and prints, beside each tree's hashes,
whether every hash agrees. Inputs, from seed 0 on the card: decode over
[8, hkv, 2112, d] caches with ragged lengths at (hq, hkv, d) = (16, 8,
128) (qwen3-1.7b), (24, 8, 64) (granite-moe-3b-a800m) and (32, 2, 128)
(chatglm3-6b), in bfloat16 and float32; the FM forward at the
serve_bulk shape (per-row v [262144, 39, 10], x the stride-0 ones) and
with one shared v [26, 16] under strided x [4096, 26]. Prints one JSON
object.
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
    raw = t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def hashes() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bits: needs a CUDA device")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fm_interaction as FI
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
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
                                 env=env, capture_output=True, text=True,
                                 check=True)
            runs.append(json.loads(run.stdout.strip().splitlines()[-1]))
        out = {"trees": runs, "identical": {
            key: runs[0]["hashes"][key] == runs[1]["hashes"][key]
            for key in runs[0]["hashes"]}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
