"""Times the port's FM backward (``fm_interaction_bwd``) at the FM train
step's shape on the card.

    PYTHONPATH=src python src/repro_torch/launch/fm_bwd.py
    python src/repro_torch/launch/fm_bwd.py --trees build/parent/src src
    PYTHONPATH=src python src/repro_torch/launch/fm_bwd.py --variants

It reaches the port only through ``repro_torch.kernels.fm_interaction``
(``fm_interaction_bwd``, and ``backward_plan`` where the tree has it)
and ``repro_torch.kernels.ref``, so with ``PYTHONPATH`` pointing at
another checkout's ``src`` it times that checkout. ``--trees A B`` runs
this script once per turn in a child process with ``PYTHONPATH`` set to
each tree's ``src``, in turns A, B, B, A (each tree builds its kernels
into its own checkout's ``build/``), and prints one JSON object with
every turn: an A/B of two trees on one card in one call. ``--variants``
times this tree's bulk route under other plans (the plan's constants
``TILE_BYTES``, ``MAX_STAGES`` and ``CTAS_PER_SM`` set in turn, each
result held to the default plan's bits) and, as a yardstick, one
``Tensor.copy_`` of v into a tensor of its size, which moves the same
bytes.

Shape: the train_batch step's gathered rows, v [65536, 39, 10] float32
contiguous, x the stride-0 ones (never read), dx not asked, g [65536];
v from N(0, 0.01) and g from N(0, 1) / 65536, seed 0, made on the card.
The time is the mean of CUDA events around 20 back-to-back calls after 3
warm-up calls, behind a device-side lead of about 10 ms
(``torch.cuda._sleep``) so that the host has queued the calls before the
first event; v (102 MB) does not fit the 50 MB L2, so each call reads it
from device memory. The result is held against ``fm_interaction_bwd_ref``
within 1e-5 of each row's |S| + |v| sums times |g| and a repeat must give
the same bits. The bound counts v read once, dv written once and g read
once at 3.35 TB/s. Prints one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

SEED = 0
B, F, K = 65536, 39, 10
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet
LEAD_CYCLES = 20_000_000        # about 10 ms of the card's clock


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def time_tree() -> dict:
    """The imported tree's backward at the train shape."""
    if not torch.cuda.is_available():
        raise SystemExit("fm_bwd: needs a CUDA device")
    from repro_torch.kernels import fm_interaction as FI, ref
    gen = torch.Generator("cuda").manual_seed(SEED)
    v = torch.randn((B, F, K), generator=gen, device="cuda") * 0.01
    g = torch.randn((B,), generator=gen, device="cuda") / B
    x = torch.ones((1, 1), device="cuda").expand(B, F)

    def backward():
        return FI.fm_interaction_bwd(x, v, g, need_dx=False)[1]

    got, again = backward(), backward()
    want = ref.fm_interaction_bwd_ref(x, v, g)[1]
    s = v.sum(1, keepdim=True)
    allowed = (1e-5 * (s.abs() + v.abs()).sum(1, keepdim=True)
               * g.abs()[:, None, None] + 1e-12)
    err = (got - want).abs()
    out = {"tree": FI.__file__, "device": torch.cuda.get_device_name(0),
           "nvidia_smi": nvidia_smi(), "shape": [B, F, K],
           "route": (FI.backward_plan(x, v).route
                     if hasattr(FI, "backward_plan") else "staged"),
           "max_abs_err": float(err.max()),
           "within_tolerance": bool((err <= allowed).all()),
           "same_bits": bool(torch.equal(got, again))}
    del got, again, want, err, allowed
    ms = cuda_ms(backward)
    bound = (2 * v.numel() * 4 + g.numel() * 4) / HBM_BYTES_PER_S * 1e3
    out.update(ms=ms, bound_ms=bound, share=bound / ms,
               plain_ms=cuda_ms(lambda: ref.fm_interaction_bwd_ref(x, v, g),
                                reps=5, warmup=1))
    return out


# plan variants of --variants: (TILE_BYTES, MAX_STAGES, CTAS_PER_SM); the
# default plan first and last
VARIANTS = ((None, None, None), (None, 2, None), (None, 3, None),
            (6400, None, None), (12800, None, None), (15600, None, None),
            (21840, None, None), (24960, None, None), (24960, 2, None),
            (51200, None, None), (None, 5, None), (None, 6, None),
            (None, None, (1,)), (None, 3, (3, 2, 1)), (None, None, None))


def time_variants() -> dict:
    """The bulk route at the train shape under each of VARIANTS, three
    timings each, and the copy yardstick."""
    from repro_torch.kernels import fm_interaction as FI
    gen = torch.Generator("cuda").manual_seed(SEED)
    v = torch.randn((B, F, K), generator=gen, device="cuda") * 0.01
    g = torch.randn((B,), generator=gen, device="cuda") / B
    x = torch.ones((1, 1), device="cuda").expand(B, F)
    names = ("TILE_BYTES", "MAX_STAGES", "CTAS_PER_SM")
    default = tuple(getattr(FI, n) for n in names)

    def backward():
        return FI.fm_interaction_bwd(x, v, g, need_dx=False)[1]

    want = backward()
    rows = []
    for var in VARIANTS:
        for n, d, val in zip(names, default, var):
            setattr(FI, n, d if val is None else val)
        plan = FI.backward_plan(x, v)
        rows.append({"plan": plan._asdict(),
                     "same_bits": bool(torch.equal(backward(), want)),
                     "ms": [cuda_ms(backward) for _ in range(3)]})
    for n, d in zip(names, default):
        setattr(FI, n, d)
    dv = torch.empty_like(v)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": nvidia_smi(), "variants": rows,
            "copy_ms": [cuda_ms(lambda: dv.copy_(v)) for _ in range(3)]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("A", "B"),
                    help="two trees' src directories, timed in turns A, B, "
                         "B, A in child processes")
    ap.add_argument("--variants", action="store_true",
                    help="time this tree's bulk route under other plans "
                         "and a copy of the same bytes")
    args = ap.parse_args(argv)
    if args.variants:
        out = time_variants()
    elif not args.trees:
        out = time_tree()
    else:
        turns = []
        for src in (args.trees[0], args.trees[1], args.trees[1],
                    args.trees[0]):
            env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
            run = subprocess.run([sys.executable, os.path.abspath(__file__)],
                                 env=env, capture_output=True, text=True,
                                 check=True)
            turns.append(dict(json.loads(run.stdout.strip().splitlines()[-1]),
                              src=src))
        out = {"turns": turns}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
