#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port of FlowLog (``src/repro_torch``) on one
NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed 0] [--scale 22]

Phases, each printing its wall time:

1. card      the card's name and power limit;
2. build     the CUDA kernels under src/repro_torch/csrc/, compiled with
             nvcc in parallel, with ptxas' register/spill report;
3. kernels   each engine kernel against its plain torch version on the
             card, at the shapes the engine gives it, timed with CUDA
             events beside its byte bound and one library call (the
             probe on unsorted probes and on the same probes sorted,
             with its ptxas registers and spills); the
             segment reduce also over a run of 2**20 rows, all-dead and
             negative ids, the embedding_bag shape (timed) and a float
             sum that rounds, run twice for the same bits;
4. attention the attention kernels against their plain versions at the
             LM shapes (qwen3-1.7b prefill at 4096 tokens in bf16 on the
             wgmma kernel and in f32 on the 3xTF32 one, a chunked
             prefill, gemma's d = 256 and chatglm3's GQA 16:1 in both
             types, decode over a 32768-position cache, each decode run
             twice for the same bits), timed beside their bounds and
             scaled_dot_product_attention, with the prefill and decode
             kernels' ptxas registers and spills;
5. engine    Reach, CC and SSSP with the port's Engine on the card over a
             Graph500 Kronecker graph (scale 22, edge factor 16, A, B, C =
             0.57, 0.19, 0.19), each checked against scipy.sparse.csgraph
             and run a second time on the same Engine (warm);
6. wide      Reach again under force_multiword(), so every key is two
             words and every probe takes the multi-word kernel;
7. device    the four runs of phases 5 and 6 in the engine's device mode
             (one iteration captured as a CUDA graph and replayed), each
             held to scipy, to host mode's iterations and to zero grow
             retries, then run again on the same Engine, which must
             replay the graph memo (no capture, a memo hit a loop) and
             give the same facts; both timed beside host mode's two
             runs; a kernel inside the graph counts once per capture,
             not per replay;
8. incremental
             Reach and CC maintained in device mode under a stream seeded
             by --seed: 2 x 65,536 new random edges, 65,536 existing
             edges deleted, then both at once, drawn from an edge set
             kept apart with numpy; after every step the engine's edge
             mirror equals that set and the state equals a batch run
             over it byte for byte, after the last also scipy; each
             apply's latency beside the batch run's time, DRed's rounds
             and candidate rows, peak memory;
8b. durable  the launcher's program (launch/incremental_serving.py:
             reachability from the vertex of largest out-degree avoiding
             1% of the vertices, quarantined, and hop counts, a MIN
             monoid) served by DurableIncrementalEngine in device mode on
             the same graph under 6 seeded batches of 65,536 new and
             65,536 deleted links, a snapshot every 2: once uninterrupted
             (the twin, its views kept on the host), each step held to a
             host-mode batch run over the edge set kept apart with numpy
             and the last to scipy; once under a seeded FaultPlan of
             crashes outside captured regions, each crash followed by a
             fresh engine, recover() and the batch re-submitted, every
             step byte-equal to the twin (views and iteration dicts);
             a cold recover(); and an engine whose idb_cap is the initial
             view's size absorbing an insert batch by the ladder's
             capacity backoff. Prints snapshot seconds and bytes, recover
             beside initialize seconds, each apply's seconds and graph
             captures (0 after the first apply), memo counts and peak
             memory;
8c. sharded the sharded engine (engine/shard.py), its shards on the
             one card, one thread each: Reach, CC and SSSP at 2 shards on
             the same graph in host mode, each held to scipy, to the
             unsharded host-mode run's facts byte for byte and its
             iterations, and to zero grow retries; Reach and Reach under
             force_multiword() at 4 shards on a graph of scale 20 in host
             and in device mode (device mode eager: a sharded iteration is
             not captured), held the same way, device mode to host mode's
             iterations; Reach (DRed) and CC (recompute) maintained at 2
             shards under one seeded batch of 65,536 new and 65,536
             deleted edges, the state byte-equal to the unsharded
             IncrementalEngine's and to a batch run over the edge set kept
             apart; the launcher's program served durably at scale 20, a
             2-shard snapshot recovered by an unsharded engine and an
             unsharded one by a 2-shard engine, each counting
             resilience.restore.rehomed and giving the writer's view.
             Prints wall s beside the unsharded runs', live rows per
             shard, one shard's all-to-all bytes, peak memory, apply and
             recover s;
9. serve     qwen3-1.7b at full width through repro_torch.launch.serve:
             random bf16 weights from --seed, 8 requests of 2048 prompt
             tokens, 64 greedy tokens, twice: a run that captures the
             attention inputs of the first and last layer, then a run
             with nothing wrapped, timed and counted, which must give
             the same tokens; the kernels held against their plain
             versions on the captured inputs in bf16 and, cast, in f32
             (the bf16 ones give the wgmma and decode kernel lines'
             times), and a short run against the same run through the
             plain versions; then the model in float32 at full depth (8
             x 2048 prompt tokens, 8 steps) the same way, its prefill on
             the 3xTF32 kernel: a capturing run, the kernels held against
             their plain versions on its float32 activations (the f32
             prefill's kernel line), then a counted run that must give
             the same tokens as it and as the run through the plain
             versions;
9b. moe      granite-moe-3b-a800m (64 greedy tokens) and
             granite-moe-1b-a400m (16) at full width and depth the same
             way: random bf16 weights from --seed, 8 x 2048 prompt
             tokens, a capturing run, then a counted run that must give
             its tokens; the attention kernels at head dim 64 and GQA
             24:8 / 16:8 held against their plain versions on the
             captured inputs; the captured MoE layers (first and last, at
             the prefill and the last decode step) on the card against
             float64 on the host (expert sets for every token of float64
             margin >= 1e-5, slots, keep and gates from the card's own
             choices, the output in bf16 and cast to f32, the dropped
             share, the routing's and the layer's time); then the same
             weights cast to float32, 2 x 96 tokens and 2 steps through
             the kernels against the plain attention with the kernel
             run's expert choices replayed (tokens equal, logits within
             1e-3 of scale);
10. recsys   the FM recommender (config fm: 39 fields, k 10, a 4,000,000-
             row table, random weights from --seed): the interaction kernel
             against its plain version at the reference's kernel-test
             shapes and at the serve_bulk shape, in float32 and bfloat16,
             timed beside its byte bound; then, counted, serve_p99 (200
             batches of 512 after 10 warm-up batches, one latency sample
             each), serve_bulk (20 batches of 262,144), retrieval_cand (20
             calls of one context against 1,000,000 candidates) with ids
             from the port's recsys_stream, a batch of out-of-range and
             negative ids, and embedding_bag over 262,144 bags of 0 to 8
             ids; logits and scores held against a float64 numpy forward
             on the host, the bags against the plain version;
10b. train  training through launch/train.py's pieces and the archs'
             train steps, deterministic algorithms on: the attention
             backward (csrc/flash_attention_bwd.cu; at d 256
             csrc/flash_attention_bwd256.cu; float32
             csrc/flash_attention_bwd_tf32.cu) against attention_bwd_ref
             on adversarial shapes (d 64, 128 and 256, GQA 1:1 to 16:1,
             causal and not, s 77 to 4096) in bf16 (the plain version in
             float32) and in float32 (the plain version in float64,
             BWD_TOL["float32"]), the forward's lse against
             attention_lse_ref, every check run twice for the same bits;
             qwen3-1.7b at full width and depth (28 layers, bf16
             weights from --seed, float32 AdamW moments, remat) at
             train_4k's 4096 tokens a sequence and the largest per-step
             batch of {8, 4, 2, 1} that its reckoned memory fits in 90% of
             the card, one warm-up step capturing the backward's inputs of
             layers 0 and 27, then 6 counted, timed steps (loss, ce and
             gnorm each step; step p50, tokens/s, peak memory, model-FLOP
             share), the backward kernels held against their plain version
             on the captured inputs and timed beside SDPA's backward; one
             step at 2 layers, B = 1, through the kernels against the same
             step through the plain versions; crash after step 4 and
             --resume at 2 layers, the final state byte-equal to an
             uninterrupted run's; the fm config at train_batch (65,536 x
             39 ids): its backward kernel on a step's rows (the route its
             plan takes printed; it must be the bulk stream), 20 counted,
             timed steps, crash and resume the same way;
10b1. train_f32  qwen3-1.7b trained in float32 the same way at full width
             and depth (28 layers, float32 weights from --seed, TF32
             off), train_4k at the largest batch its float32 reckoning
             fits (2 x 4096), one warm-up step capturing the backward's
             inputs of layers 0 and 27, 4 timed steps that must launch
             the 3xTF32 forward and the float32 backward's pre, dK/dV and
             dQ kernels and no bf16 attention kernel (model-FLOP share
             at the 67 TFLOP/s float32 peak); the float32 backward held
             against its plain version in float64 on the captured inputs
             and timed beside SDPA's float32 backward (each backend
             forced, to name the one PyTorch picks), with the forward's
             time with and without its lse; a 2-layer float32 step
             through the kernels against the plain one;
10b2. train_moe  granite-moe-1b-a400m and granite-moe-3b-a800m trained
             the same way at full width and depth (24 and 32 layers, 32
             and 40 experts, top-8, 32 routing groups; the loss ce + 0.01
             times the load-balance losses), the batch reckoned with the
             MoE layer's transients, 4 timed steps (plus the dropped share
             of each layer at the warm-up step and the model-FLOP share
             from the active parameters), the d = 64 backward on each
             step's captured inputs; a 2-layer granite-1b step through the
             kernels against the plain one, which replays the kernel
             step's routing; crash and resume at 2 layers;
10b3. train_gemma  gemma-7b at full width and the most layers one
             4096-token sequence fits (train_depth), 4 timed steps, the
             d = 256 backward held against its plain version on the
             step's captured inputs and timed beside SDPA's backward
             (and each SDPA backend forced, which names the one it picks);
10c. gnn    the four GNNs trained at full width and depth through
             launch/train.py's pieces (float32, TF32 off, deterministic
             algorithms on), each on the largest shape one card holds,
             with the reference launcher's graph: gatedgcn (16 layers, d
             70) on minibatch_lg (169,984 nodes, 168,960 edges, 602
             features), gat-cora on full_graph_sm (2,720 nodes, 10,560
             edges), dimenet (6 blocks, 128) and nequip (5 layers, 32
             channels, l_max 2) on molecule (3,840 atoms, 8,192 edges,
             dimenet's 131,072 triplets); 3 warm-up steps (the first
             capturing the segment reduce's first calls), then 10 counted,
             timed steps (p50 and p99, edges/s, peak memory, finite
             losses, the kernel's launches a step and in one forward and
             one backward apart, the model-FLOP share at 67 TFLOP/s); the
             kernel against its plain version on the captured inputs
             (gatedgcn's and dimenet's layer 0, GAT's scores and weights,
             nequip's three widths: max and min bit-equal with equal tie
             counts, sums within 1e-5 of scale), timed at gatedgcn's shape
             beside scatter_reduce; a 2-layer gatedgcn step through the
             kernel against the plain one (loss 1e-6 relative, gradients
             1e-4 of scale); crash and resume of gatedgcn at 2 layers;
11. launches each kernel's launch count over the host-mode runs of
             phases 5, 6, 9, 9b, 10, 10b, 10b1, 10b2, 10b3 and 10c (each
             counted
             from 0 just
             before it), and apart the engine kernels' calls in phases 7 and 8,
             in phase durable (a kernel inside a captured graph once
             per capture, so a memo hit adds nothing) and in the sharded
             engines' runs of phase sharded (every shard's launches); a
             zero in any fails.

With ``--profile``, each of Reach, CC and SSSP in host and in device
mode, the serve prefill, four decode steps, the float32 prefill,
granite-moe-3b-a800m's prefill, four decode steps and one MoE layer at
decode (with a "moe dispatch" family), one serve_bulk batch, one
qwen3-1.7b train step (with the cross-entropy and the AdamW update also
timed alone by CUDA events), one qwen3-1.7b float32 train step, one
granite-moe-3b-a800m train step (its
families from the ops around each launch: GEMMs, attention, the
dispatch's and the combine's backwards, routing, gathers, AdamW), one
gemma-7b train step at its cut, and one fm train_batch step (its families
from the ops around each launch: gathers, the two FM kernels, the
scatter into the table, accumulation into .grad, zeroing, global norm,
AdamW, BCE; each beside its byte bound) and one gatedgcn
minibatch_lg step (its families the same way, with the segment reduce,
its backward's gathers and the scatter of the gathers' gradients) then
run once more under
torch.profiler, which prints device time by kernel family, the device's
busy share of the run's wall time and the busiest host ops (not part of
the checks).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}, printed only if every phase
passed. Exits non-zero, with no result, when no CUDA device is present or
the repo's sources are not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA's data sheet

@contextlib.contextmanager
def phase(name):
    """Prints a phase's wall time when it ends without an error."""
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"== phase {name} done in {time.perf_counter() - t0:.3f} s",
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

LEAD_CYCLES = 20_000_000     # about 10 ms of the card's clock


def cuda_ms(torch, fn, reps=5, warmup=2, lead=True) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``reps`` back-to-back calls after ``warmup`` calls. With ``lead`` the
    device first spins for ``LEAD_CYCLES`` (``torch.cuda._sleep``), so
    the host has queued the calls before the first event: a call whose
    kernels take less time than the host takes to launch them is timed
    on the device, not at the host's launch rate (``lead=False``)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if lead:
        torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# -- phase 3: kernels against their plain versions --------------------------

def probe_inputs(torch, gen, m, n, w, dev):
    """Sorted build keys [m, w] (or [m] for w = 1) with duplicates and a
    KEY_PAD tail; unsorted probe keys [n, w] mixing hits, misses and
    KEY_PAD rows, plus a KEY_PAD tail — the engine's arrangement shapes."""
    from repro_torch.engine.relation import KEY_PAD, lex_order_words
    live = m * 3 // 4
    cols = []
    for c in range(w):
        hi = (1 << 62) if c else (1 << 20)    # ties on word 0 when w > 1
        cols.append(torch.randint(0, hi, (m,), generator=gen, device=dev,
                                  dtype=torch.int64))
    build = torch.stack(cols, dim=1)
    if w == 1:      # 62-bit keys drawn from m / 2 values: duplicates
        build[:, 0] = torch.randint(0, m // 2, (m,), generator=gen,
                                    device=dev) * ((1 << 62) // m)
    build[live:] = KEY_PAD
    build = build[lex_order_words(build)].contiguous()
    hits = build[torch.randint(0, live, (n // 2,), generator=gen,
                               device=dev)]
    miss = torch.randint(0, 1 << 62, (n - n // 2, w), generator=gen,
                         device=dev, dtype=torch.int64)
    probe = torch.cat([hits, miss])
    probe = probe[torch.randperm(n, generator=gen, device=dev)]
    probe[:: 17] = KEY_PAD                  # dead probes among live ones
    probe[n - n // 8:] = KEY_PAD            # and a dead tail
    if w == 1:
        return build[:, 0].contiguous(), probe[:, 0].contiguous()
    return build, probe.contiguous()


def probe_bytes(torch, m, w, n, lo, hi):
    """(bytes, keys): what a search of these probes must move at least,
    the probe keys read once, the two ranks written once and the build
    keys that decide the ranks (at lo - 1, lo, hi - 1 and hi), each
    distinct key read once. A search reads no other key for certain, so
    a fast one can beat a bound that reads the whole build."""
    pos = torch.cat([lo - 1, lo, hi - 1, hi]).long()
    keys = int(torch.unique(pos[(pos >= 0) & (pos < m)]).numel())
    return n * w * 8 + 2 * n * 4 + keys * w * 8, keys


def check_probe(torch, gen, dev, w, m, n):
    """The probe kernel against its plain version, exactly, on unsorted
    probes (``relops.membership``) and on the same probes sorted (the
    ``merge_ranks`` case); each timed beside the byte bound and, at
    W = 1, two ``torch.searchsorted`` calls."""
    from repro_torch.engine.relation import lex_order_words
    from repro_torch.kernels import merge_probe as MP
    build, probe = probe_inputs(torch, gen, m, n, w, dev)
    order = (torch.sort(probe).indices if w == 1
             else lex_order_words(probe))
    out = {}
    for label, keys in (("unsorted", probe), ("sorted", probe[order])):
        keys = keys.contiguous()
        lo, hi = MP.merge_probe(build, keys)
        plo, phi = MP.merge_probe_plain(build, keys)
        torch.cuda.synchronize()
        err = max(int((lo.long() - plo.long()).abs().max()),
                  int((hi.long() - phi.long()).abs().max()))
        if err:
            raise AssertionError(f"probe W={w} {label}: kernel differs from "
                                 f"the plain version (max abs err {err})")
        if label == "unsorted":
            nbytes, decide = probe_bytes(torch, m, w, n, plo, phi)
            out.update(bound_ms=bound_ms(nbytes), bound_by="bytes")
        ms = cuda_ms(torch, lambda: MP.merge_probe(build, keys))
        plain_ms = cuda_ms(torch, lambda: MP.merge_probe_plain(build, keys),
                           reps=2, warmup=1)
        library_ms = None
        if w == 1:
            library_ms = cuda_ms(torch, lambda: (
                torch.searchsorted(build, keys, side="left"),
                torch.searchsorted(build, keys, side="right")))
        print(f"probe W={w} m={m} n={n} {label} probes: exact; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms} "
              f"ms, byte bound {bound_ms(nbytes):.4f} ms ({nbytes} B with "
              f"{decide} deciding build keys; "
              f"{100 * bound_ms(nbytes) / ms:.1f}% of it)", flush=True)
        if label == "unsorted":
            out.update(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms)
        else:
            out["sorted_probes"] = dict(ms=ms, plain_ms=plain_ms,
                                        library_ms=library_ms)
    return out


def segment_inputs(torch, gen, n, d, num_segments, dtype, dev):
    """Sorted segment ids over [0, num_segments) with a dead tail at
    num_segments (out of range, dropped), and values [n, d]."""
    live = n * 7 // 8
    seg = torch.sort(torch.randint(0, num_segments, (live,), generator=gen,
                                   device=dev, dtype=torch.int32)).values
    seg = torch.cat([seg, torch.full((n - live,), num_segments,
                                     dtype=torch.int32, device=dev)])
    if dtype == torch.int32:
        vals = torch.randint(-(1 << 31), (1 << 31) - 1, (n, d),
                             generator=gen, device=dev, dtype=torch.int32)
    else:       # multiples of 2**-8: a segment's sum is exact in any order
        vals = torch.randint(0, 256, (n, d), generator=gen, device=dev,
                             dtype=torch.int32).float() / 256
    if d == 1:
        vals = vals[:, 0].contiguous()
    return vals, seg


def check_segment(torch, gen, dev, n, d, num_segments, dtype, op,
                  timed=False):
    from repro_torch.kernels import segment_reduce as SR
    vals, seg = segment_inputs(torch, gen, n, d, num_segments, dtype, dev)
    label = (f"segment_reduce {op} {str(dtype).split('.')[-1]} n={n} d={d} "
             f"segments={num_segments}")
    return check_segment_on(torch, label, vals, seg, num_segments, op, timed)


def check_segment_on(torch, label, vals, seg, num_segments, op,
                     timed=False):
    """The kernel against its plain version, exactly: int32 results, and
    float sums of values whose sums are exact in any order. With
    ``timed``, CUDA-event times of the kernel, the plain version and one
    library call (index_add_ for float sums, else scatter_reduce) beside
    the byte bound."""
    from repro_torch.kernels import segment_reduce as SR
    out = SR.segment_reduce(vals, seg, num_segments, op)
    ref = SR.segment_reduce_plain(vals, seg, num_segments, op)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        err = float((out.double() - ref.double()).abs().max())
        raise AssertionError(f"{label}: kernel differs from the plain "
                             f"version (max abs err {err})")
    err = 0.0
    if not timed:
        print(f"{label}: equal to the plain version", flush=True)
        return None
    ms = cuda_ms(torch, lambda: SR.segment_reduce(vals, seg,
                                                  num_segments, op))
    plain_ms = cuda_ms(torch, lambda: SR.segment_reduce_plain(
        vals, seg, num_segments, op), reps=2, warmup=1)
    # the library call: one scatter_reduce (or index_add_) into a buffer
    # with a spare row for the dead ids (its index must be int64 and in
    # range)
    idx = seg.long().clamp(0, num_segments)
    base = torch.full((num_segments + 1,) + tuple(vals.shape[1:]),
                      SR.ref._identity(op, vals.dtype), dtype=vals.dtype,
                      device=vals.device)
    if op == "sum":
        library_ms = cuda_ms(torch, lambda: base.index_add(0, idx, vals))
    else:
        red = {"min": "amin", "max": "amax"}[op]
        sidx = idx if vals.dim() == 1 else idx[:, None].expand_as(vals)
        library_ms = cuda_ms(torch, lambda: base.scatter_reduce(
            0, sidx, vals, reduce=red))
    n, d = vals.shape[0], (vals.shape[1] if vals.dim() == 2 else 1)
    nbytes = n * 4 + n * d * 4 + num_segments * d * 4
    print(f"{label}: equal to the plain version; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, byte bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes} B, "
          f"{100 * bound_ms(nbytes) / ms:.1f}% of it)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=library_ms)


def check_segment_edges(torch, gen, dev, big):
    """The segment reduce where tiles and ids are awkward: one id over
    2**20 rows inside ``big`` rows (a run across hundreds of tiles), every
    id dead (past the end, and negative), a head of negative ids, the
    embedding_bag shape (float32 sum, d = 10, 262,144 bags of 0 to 8 rows,
    timed), and a float32 sum of values that are not exact in any order,
    run twice: the bits must agree."""
    from repro_torch.kernels import segment_reduce as SR
    i32 = torch.int32
    seg = torch.sort(torch.randint(0, big, (big,), generator=gen,
                                   device=dev, dtype=i32)).values
    start = big // 3
    seg[start:start + (1 << 20)] = seg[start]
    vals = torch.randint(-(1 << 31), (1 << 31) - 1, (big,), generator=gen,
                         device=dev, dtype=i32)
    for op in ("sum", "min"):
        check_segment_on(torch, f"segment_reduce {op} int32 n={big}, one id "
                         f"over 2**20 rows", vals, seg, big, op)
    del seg
    n = min(1 << 20, big)
    small = vals[:n].contiguous()
    for dead, what in ((5, "past the end"), (-3, "negative")):
        ids = torch.full((n,), dead, dtype=i32, device=dev)
        check_segment_on(torch, f"segment_reduce sum int32 n={n}, every id "
                         f"dead ({what})", small, ids, 5, "sum")
    ids = torch.sort(torch.randint(-n // 20, n // 20, (n,), generator=gen,
                                   device=dev, dtype=i32)).values
    check_segment_on(torch, f"segment_reduce max int32 n={n}, ids from "
                     f"{-n // 20} (half the rows dropped at the head)", small,
                     ids, n // 20, "max")
    del vals, small
    # embedding_bag's shape (chip phase recsys): bags of 1 to 8 rows, 5%
    # empty; values multiples of 2**-8, so the sums are exact in any order
    bags = 262_144
    sizes = torch.randint(1, 9, (bags,), generator=gen, device=dev)
    sizes[torch.rand((bags,), generator=gen, device=dev) < 0.05] = 0
    ids = torch.repeat_interleave(torch.arange(bags, device=dev, dtype=i32),
                                  sizes)
    rows = (torch.randn((ids.shape[0], 10), generator=gen, device=dev)
            * 256).round() / 256
    bag = check_segment_on(torch, f"segment_reduce sum float32 embedding_bag "
                           f"n={ids.shape[0]} d=10 segments={bags}", rows,
                           ids, bags, "sum", timed=True)
    # sums that round: the same bits on every run, and near the plain
    # version (which adds in another order)
    n = min(1 << 24, big)
    vals = torch.randn((n,), generator=gen, device=dev)
    ids = torch.sort(torch.randint(0, n // 16, (n,), generator=gen,
                                   device=dev, dtype=i32)).values
    a = SR.segment_reduce(vals, ids, n // 16, "sum")
    b = SR.segment_reduce(vals, ids, n // 16, "sum")
    ref = SR.segment_reduce_plain(vals, ids, n // 16, "sum")
    mag = SR.segment_reduce_plain(vals.abs(), ids, n // 16, "sum")
    torch.cuda.synchronize()
    rel = float(((a - ref).abs() / mag.clamp_min(1e-30)).max())
    print(f"segment_reduce sum float32 n={n} randn: two runs bit-identical "
          f"{torch.equal(a, b)}; max |kernel - plain| / sum |v| {rel}",
          flush=True)
    if not torch.equal(a, b) or rel > 1e-6:
        raise AssertionError("segment_reduce: float sums not deterministic "
                             "or off the plain version")
    return bag


def run_kernel_checks(torch, seed, dev, m=1 << 26, n=1 << 22,
                      big=1 << 27):
    """Probe: build m keys, probe n keys. Segment reduce: n = segments
    = big (the engine's capacity-sized duplicate-combine)."""
    import re
    from repro_torch.kernels import _build
    for entry, lines in ptxas_lines(_build.report("merge_probe")).items():
        w = re.search(r"probe_kernelILi(\d+)E", entry)
        print(f"ptxas probe_kernel<{w.group(1) if w else '?'}>: "
              + "; ".join(lines), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    results = {}
    results["merge_probe"] = check_probe(torch, gen, dev, 1, m, n)
    for w in (2, 3, 4):
        r = check_probe(torch, gen, dev, w, m, n)
        if w == 2:       # the word count force_multiword gives the engine
            results["merge_probe_multi"] = r
    for op in ("sum", "max"):
        check_segment(torch, gen, dev, big, 1, big, torch.int32, op)
    # CC and SSSP combine duplicates with MIN over capacity-sized buffers
    results["segment_reduce"] = check_segment(
        torch, gen, dev, big, 1, big, torch.int32, "min", timed=True)
    check_segment(torch, gen, dev, big // 8, 1, big // 32, torch.float32,
                  "sum")
    check_segment(torch, gen, dev, big // 64, 64, big // 256,
                  torch.float32, "sum")
    results["segment_reduce_bag"] = check_segment_edges(torch, gen, dev, big)
    return results


# -- phases 5 to 8: the engine at real size --------------------------------

def reach_and_cc(g, n, x, y, source):
    """Reach from ``source`` and CC (each vertex with an edge, with its
    component's least vertex) of the graph ``g`` (scipy CSR, n x n, edges
    x -> y), as sorted arrays."""
    import numpy as np
    from scipy.sparse.csgraph import breadth_first_order, connected_components
    reach = np.sort(breadth_first_order(g, source, directed=True,
                                        return_predecessors=False))
    ncomp, label = connected_components(g, directed=False)
    comp_min = np.full(ncomp, n, np.int64)
    np.minimum.at(comp_min, label, np.arange(n))
    nodes = np.unique(np.concatenate([x, y]))
    return reach, np.stack([nodes, comp_min[label[nodes]]], axis=1)


def reference_answers(scale, src, dst, weights, source):
    """Reach, CC and SSSP by scipy.sparse.csgraph, as sorted arrays, and
    the distinct edges as sorted keys x << 32 | y."""
    import numpy as np
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    t0 = [time.perf_counter()]

    def stamp(what):
        now = time.perf_counter()
        print(f"  scipy reference: {what} {now - t0[0]:.3f} s", flush=True)
        t0[0] = now

    # collapse duplicate (x, y) edges to their least weight (a CSR would
    # sum them): sort packed (x, y, w) keys, keep each (x, y)'s first
    n = 1 << scale
    key = (src.astype(np.int64) << scale | dst) << 6 | weights  # w < 64
    key = sorted_unique(key)
    first = np.ones(key.shape[0], bool)
    first[1:] = (key[1:] >> 6) != (key[:-1] >> 6)
    key = key[first]
    x = (key >> (scale + 6)).astype(np.int32)
    y = ((key >> 6) & (n - 1)).astype(np.int32)
    w = (key & 63).astype(np.float64)
    g = sp.csr_matrix((w, (x, y)), shape=(n, n))
    stamp("dedupe + CSR")
    reach, cc = reach_and_cc(g, n, x, y, source)
    stamp("breadth_first_order + connected_components")
    dist = dijkstra(g, indices=source)
    stamp("dijkstra")
    hit = np.flatnonzero(np.isfinite(dist))
    sssp = np.stack([hit, dist[hit].astype(np.int64)], axis=1)
    return reach, cc, sssp, x.astype(np.int64) << 32 | y


def sorted_unique(keys):
    """np.unique of int64 keys, sorted on the card (numpy takes minutes
    for 2**26 keys on the chip host); torch's sort, not the port's."""
    import torch
    return torch.unique(torch.from_numpy(keys).cuda()).cpu().numpy()


OUTPUT = {"Reach": "reach", "CC": "cc", "SSSP": "dist"}


def hold_facts(np, label, got, want, against="the scipy reference"):
    """Facts of a run equal to ``want`` (a one-column IDB flattened)."""
    got = np.asarray(got, np.int64)
    if got.ndim == 2 and got.shape[1] == 1:
        got = got[:, 0]
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(
            f"{label}: {got.shape[0]} facts differ from {against} "
            f"({want.shape[0]} facts)")
    print(f"{label}: {got.shape[0]} facts equal {against}", flush=True)


def run_engine(torch, name, src_text, edbs, n, edge_cap, want,
               multiword=False, mode="host", title=None,
               against="the scipy reference", warm=False):
    """One counted run of ``name`` -> (launch counts, stats). With
    ``warm``, a second run on the same Engine follows, which must replay
    the graph memo's captures (no capture, memo hits) and give the same
    facts; its stats come back as ``stats.warm``."""
    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, Observation
    from repro_torch.engine.observe import REGISTRY
    from repro_torch.engine.relation import force_multiword
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.fixpoint import engine_config
    obs = Observation() if mode == "device" else None
    engine = Engine(compile_program(src_text),
                    engine_config(n, edge_cap, mode, obs))
    forced = force_multiword() if multiword else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with forced:
        out, stats = engine.run(edbs)
    torch.cuda.synchronize()
    counts = launch_counts()
    label = (f"{title or name}{' (force_multiword)' if multiword else ''}, "
             f"{mode} mode")
    if warm:
        captures = REGISTRY.get("engine.graph_captures")
        hits = obs.registry.get("memo_jit.hit") if obs else 0
        with force_multiword() if multiword else contextlib.nullcontext():
            again, stats.warm = engine.run(edbs)
        torch.cuda.synchronize()
        captures = REGISTRY.get("engine.graph_captures") - captures
        memo = (f", graph captures {captures}, memo hits "
                f"{obs.registry.get('memo_jit.hit') - hits}" if obs else "")
        print(f"{label}, warm second run on the same Engine: wall "
              f"{stats.warm.wall_s:.4f} s{memo}, peak memory "
              f"{torch.cuda.max_memory_allocated()} B allocated, "
              f"{torch.cuda.max_memory_reserved()} B reserved", flush=True)
        loops = sum(1 for v in stats.iterations.values() if v > 0)
        if obs and (captures or obs.registry.get("memo_jit.hit") - hits
                    != loops):
            raise AssertionError(f"{label}: the warm run captured "
                                 f"{captures} graphs, memo hits "
                                 f"{obs.registry.get('memo_jit.hit') - hits}"
                                 f" for {loops} loops")
        if stats.warm.iterations != stats.iterations or any(
                not np.array_equal(again[k], out[k]) for k in out):
            raise AssertionError(f"{label}: the warm run differs")
    print(f"{label}: iterations {stats.iterations}, wall "
          f"{stats.wall_s:.4f} s, grow_retries {stats.grow_retries}, "
          f"peak memory {torch.cuda.max_memory_allocated()} B allocated, "
          f"{torch.cuda.max_memory_reserved()} B reserved, facts "
          f"{stats.total_facts}, launches {counts}", flush=True)
    if obs is not None:
        print(f"{label}: fixpoint loop "
              f"{[round(sp.dur, 4) for sp in obs.find('fixpoint-loop')]} s, "
              f"of which graph capture "
              f"{[round(sp.dur, 4) for sp in obs.find('graph-capture')]} s",
              flush=True)
    if stats.grow_retries:
        raise AssertionError(f"{label}: {stats.grow_retries} grow retries")
    hold_facts(np, label, out[OUTPUT[name]], want, against)
    stats.facts = out[OUTPUT[name]]     # phase sharded holds its runs to it
    return counts, stats


FAMILIES = (("fm_interaction (ours)", ("fm_kernel",)),
            ("probe (ours)", ("probe_kernel",)),
            ("segment_reduce (ours)", ("segment_reduce", "reduce_tiles",
                                       "fill_identity", "combine_crossing")),
            ("attention (ours)", ("attn_tf32", "attn_wgmma", "decode_split",
                                  "decode_combine")),
            ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
            ("sort", ("sort", "radix")),
            ("memcpy/memset", ("memcpy", "memset")),
            ("index/scatter/gather", ("index", "scatter", "gather")),
            ("attention backward (ours)", ("bwd_dkdv", "bwd_dq", "bwd_pre",
                                           "bwd256")),
            ("fm_interaction backward (ours)", ("fm_bwd_kernel",
                                                "fm_bwd_stream_kernel")))
# the FM train step's families (``scoped_family``, in this order): the
# kernels by name, then autograd's nodes and the step's record_function
# scopes (``run_fm_train``) around the ops that launched the rest
FM_STEP_FAMILIES = (
    ("fm_interaction (ours)", ("fm_kernel",)),
    ("fm_interaction backward (ours)", ("fm_bwd_",)),
    ("scatter into the table (IndexSelectBackward)", ("indexselectbackward",)),
    ("gathers (index_select)", ("indexselect", "aten::index_select")),
    ("accumulate into .grad (AccumulateGrad)", ("accumulategrad",)),
    ("zero the gradients", ("fm.zero_grads",)),
    ("global norm", ("fm.global_norm",)),
    ("AdamW", ("fm.adamw",)),
    ("BCE, linear term and bias", ("fm.loss", "fm.backward",
                                   "evaluate_function")))
# in a MoE model's profile, after gemm: the router's softmax and top-k,
# the dispatch's sort, searchsorted and scatter, the buffer's index copy
# and gather (with them the embedding gather and the KV cache's index
# put, two kernels a layer at decode, which share their names)
MOE_DISPATCH = ("moe dispatch", ("softmax", "topk", "sort", "radix",
                                 "searchsorted", "scatter", "gather",
                                 "index"))


def kernel_family(name: str, moe: bool = False) -> str:
    low = name.lower()
    families = (FAMILIES[:5] + (MOE_DISPATCH,) + FAMILIES[5:] if moe
                else FAMILIES)
    for family, marks in families:
        if any(m in low for m in marks):
            return family
    return "other elementwise/reduce"


def scoped_family(kernel: str, ops: list, families) -> str:
    """The first of ``families`` ((family, marks), ...) with a mark in the
    kernel's name or in the name of an op around its launch (``ops``, the
    launching op and its parents, lower case)."""
    names = [kernel.lower()] + ops
    for family, marks in families:
        if any(m in n for m in marks for n in names):
            return family
    return "other"


def profile_run(torch, name, fn, moe=False, families=None):
    """``fn()`` under torch.profiler, once as a warm-up step and once
    recorded (a profile that is not the process's first drops the first
    kernels it sees): device time per kernel family (``moe``: with the
    MoE dispatch's; ``families``: by ``scoped_family``, which also reads
    the ops around each launch, record_function scopes and autograd's
    nodes included), the device's busy share (kernel time over the
    recorded run's wall time) and kernel count, and the host ops with
    the most self CPU time. Returns {family: ms} (None when the profiler
    saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    by_family: dict = {}
    top, host = [], []
    device_ms = 0.0
    averages = prof.key_averages()
    # a record_function scope also shows on the device's timeline under
    # its own name: not a kernel
    cpu_names = {e.key for e in averages
                 if getattr(e, "device_type", None) != DeviceType.CUDA}
    for e in averages:
        if e.key.startswith("ProfilerStep"):    # the step's own range
            continue
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key[:60]))
            continue
        if e.key in cpu_names:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        top.append((us / 1e3, e.count, e.key[:90]))
        device_ms += us / 1e3
        if families is None:
            fam = kernel_family(e.key, moe)
            ms, count = by_family.get(fam, (0.0, 0))
            by_family[fam] = (ms + us / 1e3, count + e.count)
    if families is not None:
        for e in prof.events():
            if not getattr(e, "kernels", None):
                continue
            ops, op = [], e
            while op is not None:
                ops.append(op.name.lower())
                op = op.cpu_parent
            for kern in e.kernels:
                fam = scoped_family(kern.name, ops, families)
                ms, count = by_family.get(fam, (0.0, 0))
                by_family[fam] = (ms + kern.duration / 1e3, count + 1)
        # kernels whose launch no recorded op encloses
        rest = device_ms - sum(ms for ms, _ in by_family.values())
        if rest > 1e-3:
            by_family["no op around the launch"] = (rest, 0)
    families = by_family
    busy = sum(ms for ms, _ in families.values())
    if not families:
        print(f"profile {name}: the profiler saw no device time "
              f"(not measured)", flush=True)
        return None
    kernels = sum(count for _, count in families.values())
    print(f"profile {name}: wall {wall_ms:.3f} ms under the profiler, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) in "
          f"{kernels} kernels")
    for fam, (ms, count) in sorted(families.items(), key=lambda x: -x[1][0]):
        print(f"  {fam}: {ms:.3f} ms in {count} kernels "
              f"({100 * ms / wall_ms:.1f}% of wall)")
    for ms, count, key in sorted(top, reverse=True)[:8]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key}")
    print("  host, most self CPU time:")
    for ms, count, key in sorted(host, reverse=True)[:6]:
        print(f"    {ms:9.3f} ms  x{count:<5d} {key}")
    sys.stdout.flush()
    return {fam: ms for fam, (ms, _) in families.items()}


def profile_engine(torch, name, text, edbs, n, edge_cap, mode):
    """One warm engine run under torch.profiler."""
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine
    from repro_torch.launch.fixpoint import engine_config
    engine = Engine(compile_program(text), engine_config(n, edge_cap, mode))
    profile_run(torch, f"{name}, {mode} mode", lambda: engine.run(edbs))


def add_counts(totals: dict, counts: dict) -> None:
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def run_engine_phases(torch, seed, scale, profile=False):
    """Phases engine, wide, device, incremental, durable and sharded;
    with ``profile``, the host- and device-mode runs again under
    torch.profiler. Returns the launch counts of the host-mode runs and,
    apart, the wrapper calls of the device-mode and incremental runs, of
    the durable phase (where a kernel inside a captured graph counts once
    per capture and not per replay) and of the sharded engines."""
    import numpy as np
    from repro_torch.launch.fixpoint import (
        CC, EDGE_FACTOR, REACH, SSSP, kronecker_edges)
    n = 1 << scale
    t0 = time.perf_counter()
    src, dst, weights = kronecker_edges(scale, EDGE_FACTOR, seed)
    outdeg = np.bincount(src, minlength=n)
    source = int(np.argmax(outdeg))
    print(f"graph: scale {scale}, {n} vertices, {src.shape[0]} directed "
          f"edges before dedupe, source {source} (out-degree "
          f"{int(outdeg[source])}), made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    want_reach, want_cc, want_sssp, edge_keys = reference_answers(
        scale, src, dst, weights, source)
    print(f"scipy references in {time.perf_counter() - t0:.3f} s",
          flush=True)
    edges = np.stack([src, dst], axis=1)
    wedges = np.stack([src, dst, weights], axis=1)
    sources = np.array([[source]])
    edge_cap = EDGE_FACTOR * n
    totals: dict = {}       # host mode: every launch
    captured: dict = {}     # device mode: a captured kernel once
    runs = [("Reach", REACH, {"edge": edges, "source": sources},
             want_reach, False),
            ("CC", CC, {"edge": edges}, want_cc, False),
            ("SSSP", SSSP, {"edge": wedges, "source": sources},
             want_sssp, False),
            ("Reach", REACH, {"edge": edges, "source": sources},
             want_reach, True)]
    host = {}
    with phase("engine"):
        for name, text, edbs, want, mw in runs[:3]:
            counts, host[name, mw] = run_engine(
                torch, name, text, edbs, n, edge_cap, want, mw, warm=True)
            add_counts(totals, counts)
    with phase("wide"):
        name, text, edbs, want, mw = runs[3]
        counts, host[name, mw] = run_engine(
            torch, name, text, edbs, n, edge_cap, want, mw, warm=True)
        add_counts(totals, counts)
    with phase("device"):
        # a kernel inside the graph counts once per capture: a replay
        # calls no wrapper
        for name, text, edbs, want, mw in runs:
            counts, stats = run_engine(torch, name, text, edbs, n,
                                       edge_cap, want, mw, mode="device",
                                       warm=True)
            add_counts(captured, counts)
            h = host[name, mw]
            if stats.iterations != h.iterations:
                raise AssertionError(
                    f"{name}: device mode's iterations {stats.iterations} "
                    f"differ from host mode's {h.iterations}")
            print(f"{name}{' (force_multiword)' if mw else ''}: device "
                  f"mode {stats.wall_s:.4f} s (capturing), warm "
                  f"{stats.warm.wall_s:.4f} s (memo hits); host mode "
                  f"{h.wall_s:.4f} s, warm {h.warm.wall_s:.4f} s",
                  flush=True)
            del stats.warm
            gc.collect()
            torch.cuda.empty_cache()
    with phase("incremental"):
        add_counts(captured, run_incremental(
            torch, seed, n, edge_cap, edges, edge_keys, source))
    with phase("durable"):
        durable = run_durable(torch, seed, n, edge_cap, edges, edge_keys,
                              source)
    with phase("sharded"):
        sharded = run_sharded(torch, seed, n, edge_cap, runs, host,
                              edges, edge_keys, source)
    if profile:
        with phase("profile"):
            for name, text, edbs, _, _ in runs[:3]:
                for mode in ("host", "device"):
                    profile_engine(torch, name, text, edbs, n, edge_cap,
                                   mode)
    return totals, captured, durable, sharded


def new_edges(np, rng, keys, n, k):
    """k distinct random edges over n vertices absent from ``keys``
    (sorted edge keys x << 32 | y), as keys in the order drawn."""
    pick = rng.integers(0, n, size=(2 * k, 2))
    new = pick[:, 0] << 32 | pick[:, 1]
    idx = np.minimum(np.searchsorted(keys, new), len(keys) - 1)
    new = new[keys[idx] != new]
    _, first = np.unique(new, return_index=True)
    new = new[np.sort(first)][:k]
    if len(new) < k:
        raise AssertionError(f"drew {len(new)} new edges, wanted {k}")
    return new


def some_edges(np, rng, keys, k):
    """k distinct keys of ``keys``, in random order."""
    idx = np.unique(rng.integers(0, len(keys), size=2 * k))
    return keys[rng.permutation(idx)[:k]]


def edge_rows(np, keys):
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)


INC_BATCH = 1 << 16
INC_STEPS = (("insert", INC_BATCH, 0), ("insert", INC_BATCH, 0),
             ("delete", 0, INC_BATCH), ("mixed", INC_BATCH, INC_BATCH))


def run_incremental(torch, seed, n, edge_cap, edges, edge_keys, source):
    """Reach and CC maintained in device mode under a stream seeded by
    ``seed``: two batches of 65,536 new random edges, a batch of 65,536
    existing edges deleted, and a batch of both. The edge set is kept
    apart from the engine, as sorted keys (``edge_keys``, the distinct
    ``edges``) updated with numpy, and the updates are drawn from it.
    After every step the engine's edge mirror must equal it, and the
    maintained state must equal, byte for byte, a device-mode batch run
    of the port over it; after the last, scipy over it. Prints each
    apply's latency beside the batch run's time, each stratum's
    strategy, DRed's rounds and candidate rows, and the peak memory of
    the two engines held together. Returns the wrapper calls of the
    maintained runs (initialize and applies; a kernel inside a captured
    graph counts once per capture)."""
    import numpy as np
    import scipy.sparse as sp
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, Observation, make_engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.fixpoint import CC, REACH, engine_config
    totals: dict = {}
    # a join row is one edge, and the stream adds edges
    edge_cap += sum(k_ins for _, k_ins, _ in INC_STEPS)
    for name, text in (("Reach", REACH), ("CC", CC)):
        rng = np.random.default_rng((seed, len(name)))
        cp = compile_program(text)
        obs = Observation()
        inc = make_engine(cp, engine_config(n, edge_cap, "device", obs),
                          incremental=True)
        batch = Engine(cp, engine_config(n, edge_cap, "device"))
        edbs = {"edge": edges}
        if name == "Reach":
            edbs["source"] = np.array([[source]])
        keys = edge_keys
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        inc.initialize(edbs)
        torch.cuda.synchronize()
        print(f"incremental {name}: initialize {time.perf_counter() - t0:.4f}"
              f" s (a device-mode batch run and the edge mirror of "
              f"{len(inc.edbs['edge'])} rows), iterations "
              f"{inc._stats.iterations}", flush=True)
        counted = launch_counts()
        for step, (kind, k_ins, k_del) in enumerate(INC_STEPS):
            ins = new_edges(np, rng, keys, n, k_ins)
            dele = some_edges(np, rng, keys, k_del)
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = inc.apply(
                inserts={"edge": edge_rows(np, ins)} if k_ins else {},
                deletes={"edge": edge_rows(np, dele)} if k_del else {})
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t0
            add_counts(counted, launch_counts())
            ap = obs.find("apply")[-1]
            strategies = [(s.attrs["key"], s.attrs["strategy"])
                          for s in ap.find("maintain-stratum")]
            dred = [(s.attrs["rounds"], s.attrs["candidate_rows"])
                    for s in ap.find("dred-candidates")]
            # the edge set after the step: merge, never a full sort (numpy
            # sorts 65M keys slowly)
            ins = np.sort(ins)
            keys = np.insert(keys, np.searchsorted(keys, ins), ins)
            keys = np.delete(keys, np.searchsorted(keys, dele))
            mirror = inc.edbs["edge"].astype(np.int64)
            if not np.array_equal(mirror[:, 0] << 32 | mirror[:, 1], keys):
                raise AssertionError(
                    f"incremental {name} step {step} ({kind}): the edge "
                    f"mirror's {len(mirror)} rows differ from the "
                    f"{len(keys)} edges kept apart")
            out, stats = batch.run({**edbs, "edge": edge_rows(np, keys)})
            if stats.grow_retries:
                raise AssertionError(f"{name} batch: grow retries")
            for rel in out:
                if not np.array_equal(snap[rel], out[rel]):
                    raise AssertionError(
                        f"incremental {name} step {step} ({kind}): {rel} "
                        f"differs from the batch run ({len(snap[rel])} "
                        f"against {len(out[rel])} rows)")
            print(f"incremental {name} step {step} ({kind}, +{k_ins} "
                  f"-{k_del} edges): apply {apply_s:.4f} s (maintenance "
                  f"{ap.dur:.4f} s), batch run {stats.wall_s:.4f} s; "
                  f"strategies {strategies}, DRed (rounds, candidate "
                  f"rows) {dred}, iterations {inc._stats.iterations}; "
                  f"edge mirror equals the {len(keys)} edges kept apart, "
                  f"{len(snap[OUTPUT[name]])} facts equal the batch run's",
                  flush=True)
        x, y = (keys >> 32).astype(np.int32), (keys & 0xFFFFFFFF).astype(
            np.int32)
        g = sp.csr_matrix((np.ones(len(keys)), (x, y)), shape=(n, n))
        reach, cc = reach_and_cc(g, n, x, y, source)
        hold_facts(np, f"incremental {name}, after the last step",
                   snap[OUTPUT[name]], reach if name == "Reach" else cc)
        print(f"incremental {name}: launches {counted}; peak memory of the "
              f"incremental and batch engines together "
              f"{torch.cuda.max_memory_allocated()} B allocated, "
              f"{torch.cuda.max_memory_reserved()} B reserved", flush=True)
        add_counts(totals, counted)
        del inc, batch, snap, out
        torch.cuda.empty_cache()
    return totals


# -- phase durable: durable incremental serving -------------------------------

DURABLE_BATCH = 1 << 16
DURABLE_STEPS = 6
LAUNCHER_SCALE = 20     # the launcher's card command in README.md
LAUNCHER_UPDATES = 12   # and a cut of its default stream of 30
# crash sites outside any captured region
DURABLE_SITES = ("wal.before_append", "resilience.after_log",
                 "incremental.apply", "checkpoint.commit",
                 "checkpoint.retention")


def durable_stream(np, seed, n, edge_keys):
    """DURABLE_STEPS batches, each of DURABLE_BATCH new random links and
    as many existing ones deleted, drawn from the edge set kept apart
    (sorted keys x << 32 | y) -> [(inserted keys, deleted keys, the edge
    set after the step)]."""
    rng = np.random.default_rng((seed, 18))
    keys, out = edge_keys, []
    for _ in range(DURABLE_STEPS):
        ins = new_edges(np, rng, keys, n, DURABLE_BATCH)
        dele = some_edges(np, rng, keys, DURABLE_BATCH)
        srt = np.sort(ins)
        keys = np.insert(keys, np.searchsorted(keys, srt), srt)
        keys = np.delete(keys, np.searchsorted(keys, dele))
        out.append((ins, dele, keys))
    return out


def durable_reference(np, n, keys, source, quarantined):
    """reaches and pathlen over the edge set ``keys`` by scipy: BFS hop
    counts from ``source`` over the links into hosts not quarantined."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path
    x, y = keys >> 32, keys & 0xFFFFFFFF
    barred = np.zeros(n, bool)
    barred[quarantined] = True
    keep = ~barred[y]
    g = sp.csr_matrix((np.ones(int(keep.sum())), (x[keep], y[keep])),
                      shape=(n, n))
    dist = shortest_path(g, unweighted=True, indices=source)
    hit = np.flatnonzero(np.isfinite(dist))
    return hit, np.stack([hit, dist[hit].astype(np.int64)], axis=1)


def durable_batch_run(np, cp, n, edge_cap, edbs, keys):
    """The view by a host-mode batch run of the port over the edge set."""
    from repro_torch.engine import Engine
    from repro_torch.launch.fixpoint import engine_config
    out, stats = Engine(cp, engine_config(n, edge_cap, "host")).run(
        {**edbs, "link": edge_rows(np, keys)})
    if stats.grow_retries:
        raise AssertionError("durable batch run: grow retries")
    return {k: out[k] for k in ("reaches", "pathlen")}, stats.wall_s


def hold_view(np, label, got, want, got_iters=None, want_iters=None):
    for rel in ("reaches", "pathlen"):
        if not np.array_equal(got[rel], want[rel]):
            raise AssertionError(f"{label}: {rel} differs ({len(got[rel])} "
                                 f"against {len(want[rel])} rows)")
    if got_iters != want_iters:
        raise AssertionError(f"{label}: iterations {got_iters} differ "
                             f"from {want_iters}")


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def run_durable(torch, seed, n, edge_cap, edges, edge_keys, source):
    """The port's durable incremental serving (engine/resilience.py) in
    device mode: the launcher's program (launch/incremental_serving.py)
    over the graph, one source, 1% of the vertices quarantined, under a
    stream of DURABLE_STEPS batches and snapshots every 2 batches.

    (a)-(b) the stream uninterrupted (the twin), each step's view kept
    on the host; (c) the same stream under a seeded FaultPlan of crashes
    at DURABLE_SITES, each crash followed by close(), a fresh engine,
    recover() and the batch re-submitted; (d) after every step the view
    and the iteration dict equal the twin's, and the view equals a
    host-mode batch run over the edge set kept apart; after the last,
    scipy; a cold recover() gives the final view; (e) an engine whose
    idb_cap is the initial view's size absorbs an insert batch through
    the ladder's capacity backoff; (f) the launcher serves the Graph500
    graph at LAUNCHER_SCALE in device mode with --durable (its crash and
    ladder demo included), and its final view equals scipy's over the
    links of its last snapshot. Prints snapshot, recover, initialize
    and apply times, snapshot bytes, graph captures per apply (0 after
    the first apply at unchanged caps), memo counts and peak memory.
    Returns the wrapper calls of the durable path: the twin, the crash
    run, the recoveries, the ladder's engine and the launcher, not the
    batch runs they are checked against."""
    import shutil

    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import (
        DurableIncrementalEngine, EngineConfig, Observation,
        ResilienceConfig,
    )
    from repro_torch.engine import faults as F
    from repro_torch.engine.observe import REGISTRY
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch import incremental_serving
    cp = compile_program(incremental_serving.PROGRAM)
    rng = np.random.default_rng((seed, 19))
    quarantined = rng.choice(n, size=n // 100, replace=False)
    quarantined = np.sort(quarantined[quarantined != source])
    edbs = {"link": edges, "monitor": np.array([[source]]),
            "quarantined": quarantined[:, None]}
    t0 = time.perf_counter()
    stream = durable_stream(np, seed, n, edge_keys)
    print(f"durable: {DURABLE_STEPS} steps of +{DURABLE_BATCH} "
          f"-{DURABLE_BATCH} links drawn in {time.perf_counter() - t0:.3f}"
          f" s; {len(quarantined)} hosts quarantined, source {source}",
          flush=True)
    batches = [dict(inserts={"link": edge_rows(np, ins)},
                    deletes={"link": edge_rows(np, dele)})
               for ins, dele, _ in stream]
    cap = edge_cap + DURABLE_STEPS * DURABLE_BATCH
    root = ROOT / "build" / "durable"
    shutil.rmtree(root, ignore_errors=True)

    def config(obs, idb_cap=n):
        return EngineConfig(idb_cap=idb_cap, intermediate_cap=cap,
                            mode="device", observe=obs)

    def view(out):
        return {k: out[k] for k in ("reaches", "pathlen")}

    def release():
        # an engine's graphs and relations go with its last reference
        gc.collect()
        torch.cuda.empty_cache()

    rcfg = ResilienceConfig(snapshot_every=2)
    counted: dict = {}

    def tally():
        # the launches since the last reset_launch_counts() are the
        # durable path's
        add_counts(counted, launch_counts())

    # (a), (b): the twin
    obs = Observation("durable twin")
    twin = DurableIncrementalEngine(cp, config(obs), directory=root / "twin",
                                    resilience=rcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captures = REGISTRY.get("engine.graph_captures")
    reset_launch_counts()
    t0 = time.perf_counter()
    out = twin.initialize(edbs)
    init_s = time.perf_counter() - t0
    snap = obs.find("resilience-snapshot")[-1]
    print(f"durable twin: initialize {init_s:.4f} s (a device-mode batch "
          f"run, the edge mirror, snapshot 0 in {snap.dur:.4f} s, "
          f"{dir_bytes(root / 'twin' / 'snapshots')} B), graph captures "
          f"{REGISTRY.get('engine.graph_captures') - captures}, "
          f"iterations {twin.inc._stats.iterations}", flush=True)
    views = [view(out)]
    iters = [dict(twin.inc._stats.iterations)]
    for step, ((ins, dele, keys), batch) in enumerate(zip(stream, batches)):
        captures = REGISTRY.get("engine.graph_captures")
        snaps = len(obs.find("resilience-snapshot"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = twin.apply(**batch)
        torch.cuda.synchronize()
        apply_s = time.perf_counter() - t0
        captures = REGISTRY.get("engine.graph_captures") - captures
        mirror = twin.inc.edbs["link"].astype(np.int64)
        if not np.array_equal(mirror[:, 0] << 32 | mirror[:, 1], keys):
            raise AssertionError(f"durable twin step {step}: the link "
                                 f"mirror differs from the edge set")
        views.append(view(out))
        iters.append(dict(twin.inc._stats.iterations))
        ap = obs.find("durable-apply")[-1]
        strategies = [(sp_.attrs["key"], sp_.attrs["strategy"])
                      for sp_ in ap.find("maintain-stratum")]
        written = obs.find("resilience-snapshot")[snaps:]
        print(f"durable twin step {step}: apply {apply_s:.4f} s (WAL + "
              f"maintenance {ap.dur:.4f} s"
              + (f", snapshot {written[0].dur:.4f} s" if written else "")
              + f"), graph captures {captures}, strategies {strategies}, "
              f"iterations {iters[-1]}, {len(out['reaches'])} hosts "
              f"reached", flush=True)
        if step and captures:
            raise AssertionError(f"durable twin step {step}: {captures} "
                                 f"graph captures at unchanged caps")
    tally()
    print(f"durable twin: memo {obs.registry.counters_snapshot('memo_jit')}"
          f", snapshots {obs.registry.get('resilience.snapshots')}, "
          f"{dir_bytes(root / 'twin' / 'snapshots')} B kept, peak memory "
          f"{torch.cuda.max_memory_allocated()} B allocated, "
          f"{torch.cuda.max_memory_reserved()} B reserved", flush=True)
    twin.close()
    del twin
    release()

    # (d) against batch runs over the edge set, and scipy after the last
    t0 = time.perf_counter()
    walls = []
    for step, (_, _, keys) in enumerate(stream):
        want, wall = durable_batch_run(np, cp, n, cap, edbs, keys)
        walls.append(round(wall, 4))
        hold_view(np, f"durable twin step {step} against a batch run",
                  views[step + 1], want)
    reach, hops = durable_reference(np, n, stream[-1][2], source,
                                    quarantined)
    hold_facts(np, "durable, after the last step: reaches",
               views[-1]["reaches"], reach)
    if not np.array_equal(views[-1]["pathlen"], hops):
        raise AssertionError("durable, after the last step: pathlen "
                             "differs from scipy's hop counts")
    print(f"durable: every step equals a host-mode batch run (wall "
          f"{walls} s) and the last scipy's reachability and hop counts "
          f"({len(hops)} rows), checked in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.empty_cache()

    # (c) the crashing run
    obs = Observation("durable crashes")
    plan = F.FaultPlan.seeded(seed, DURABLE_SITES, n_faults=3, max_hit=4)
    print(f"durable: fault plan {plan.specs}", flush=True)
    reset_launch_counts()
    box = {"dur": DurableIncrementalEngine(
        cp, config(obs), directory=root / "crash", resilience=rcfg)}
    crashes = []

    def restart():
        while True:                 # recovery itself may crash again
            try:
                box.pop("dur").close()
                release()
                box["dur"] = DurableIncrementalEngine(
                    cp, config(obs), directory=root / "crash",
                    resilience=rcfg)
                if not box["dur"].recoverable():
                    box["dur"].initialize(edbs)
                    return
                before = obs.registry.get("resilience.replayed_updates")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                box["dur"].recover()
                torch.cuda.synchronize()
                k = obs.registry.get("resilience.replayed_updates") - before
                print(f"  recover {time.perf_counter() - t0:.4f} s: the "
                      f"snapshot at seq {box['dur'].applied_seq - k} and "
                      f"{k} records replayed", flush=True)
                return
            except F.SimulatedCrash as e:
                crashes.append(str(e))

    def until_done(op):
        while True:
            try:
                return op()
            except F.SimulatedCrash as e:
                crashes.append(str(e))
                print(f"  {e}", flush=True)
                restart()           # then re-submit the in-flight op

    with F.install(plan):
        until_done(lambda: box["dur"].initialize(edbs))
        for step, batch in enumerate(batches):
            out = until_done(lambda: box["dur"].apply(**batch))
            hold_view(np, f"durable crash run step {step} against the twin",
                      view(out), views[step + 1],
                      box["dur"].inc._stats.iterations, iters[step + 1])
    print(f"durable: {len(crashes)} crashes absorbed ({plan.fired}); every "
          f"step equals the twin's view and iterations byte for byte",
          flush=True)
    if not crashes:
        raise AssertionError("durable: no crash fired")
    box.pop("dur").close()
    release()
    obs = Observation("durable cold recover")
    cold = DurableIncrementalEngine(cp, config(obs),
                                    directory=root / "crash")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = cold.recover()
    torch.cuda.synchronize()
    tally()
    k = obs.registry.get("resilience.replayed_updates")
    print(f"durable: cold recover {time.perf_counter() - t0:.4f} s (the "
          f"snapshot at seq {cold.applied_seq - k} and {k} records "
          f"replayed) against initialize {init_s:.4f} s", flush=True)
    hold_view(np, "durable cold recover", view(final), views[-1],
              cold.inc._stats.iterations, iters[-1])
    cold.close()
    del cold, final
    release()

    # (e) the ladder: the first insert batch overflows the view
    obs = Observation("durable ladder")
    idb_cap = len(views[0]["reaches"])
    reset_launch_counts()
    lad = DurableIncrementalEngine(cp, config(obs, idb_cap),
                                   directory=root / "ladder")
    lad.initialize(edbs)
    retraces = obs.registry.get("memo_jit.retrace")
    t0 = time.perf_counter()
    out = lad.apply(inserts=batches[0]["inserts"])
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    tally()
    ladder = obs.registry.counters_snapshot("resilience.ladder.")
    if (not ladder.get("resilience.ladder.capacity_backoff")
            or ladder.get("resilience.ladder.capacity_recovered") != 1
            or ladder.get("resilience.ladder.stratum_recompute")):
        raise AssertionError(f"durable ladder: rungs {ladder}")
    srt = np.sort(stream[0][0])
    keys = np.insert(edge_keys, np.searchsorted(edge_keys, srt), srt)
    want, _ = durable_batch_run(np, cp, n, cap, edbs, keys)
    hold_view(np, "durable ladder against a batch run", view(out), want)
    print(f"durable ladder: idb_cap {idb_cap} (the initial view), an insert "
          f"batch of {DURABLE_BATCH} links absorbed in {apply_s:.4f} s by "
          f"{ladder}, caps now {lad.engine.effective_caps()}, memo retraces "
          f"{obs.registry.get('memo_jit.retrace') - retraces}; the view "
          f"equals a batch run's; peak memory "
          f"{torch.cuda.max_memory_allocated()} B allocated, "
          f"{torch.cuda.max_memory_reserved()} B reserved", flush=True)
    lad.close()
    del lad
    release()

    # (f) the launcher, as a user serves a graph durably on the card
    served_dir = root / "launcher"
    argv = ["--graph", "kronecker", "--scale", str(LAUNCHER_SCALE),
            "--updates", str(LAUNCHER_UPDATES), "--mode", "device",
            "--durable", str(served_dir)]
    print(f"durable launcher: python -m repro_torch.launch."
          f"incremental_serving {' '.join(argv)}", flush=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    served = incremental_serving.main(argv)
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    tally()
    manifest, snap = load_checkpoint(served_dir / "snapshots")
    # a batch re-submitted after a crash that its WAL record survived is
    # logged again, so the stream ends at a seq past LAUNCHER_UPDATES
    if manifest["extra"]["applied_seq"] < LAUNCHER_UPDATES:
        raise AssertionError(f"durable launcher: last snapshot at seq "
                             f"{manifest['extra']['applied_seq']}")
    snap = {k[2:-2]: v for k, v in snap.items()}    # "['rows::link']"
    links = snap["rows::link"].astype(np.int64)
    keys = np.unique(links[:, 0] << 32 | links[:, 1])
    target = int(snap["rows::monitor"][0, 0])
    reach, hops = durable_reference(
        np, 1 << LAUNCHER_SCALE, keys, target,
        snap["rows::quarantined"][:, 0].astype(np.int64))
    hold_facts(np, "durable launcher: reaches after the stream",
               served["reaches"], reach)
    if not np.array_equal(np.asarray(served["pathlen"], np.int64), hops):
        raise AssertionError("durable launcher: pathlen differs from "
                             "scipy's hop counts")
    print(f"durable launcher: served in {served_s:.4f} s; its view equals "
          f"scipy's over the {len(keys)} links of its last snapshot (seq "
          f"{manifest['extra']['applied_seq']})", flush=True)
    del served, snap, links
    release()
    shutil.rmtree(root, ignore_errors=True)
    print(f"durable: launches {counted}", flush=True)
    return counted


# -- phase sharded: the sharded engine, its shards on the one card ------------

SHARDS = 2              # at the engine phase's scale
SHARDS_WIDE = 4         # at SHARD_SCALE
SHARD_SCALE = 20
SHARD_BATCH = 1 << 16


def run_sharded_engine(torch, label, name, text, edbs, n, edge_cap, want,
                       shards, mode="host", multiword=False, unsharded=None):
    """One run of ``name`` on the sharded engine -> (launch counts,
    stats). Held to ``want`` (scipy), to zero grow retries and, given the
    unsharded host-mode run's stats, to its facts byte for byte and its
    iterations. Prints wall s beside the unsharded run's, the output's
    live rows per shard, one shard's all-to-all bytes
    (``shard.all_to_all.bytes``, the reference's count: S x cap x planes
    x 4 a launch), the edge relation's send buffer by that formula, and
    peak memory."""
    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import make_engine
    from repro_torch.engine.observe import REGISTRY
    from repro_torch.engine.relation import force_multiword, pow2_cap
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.fixpoint import engine_config
    engine = make_engine(compile_program(text),
                         engine_config(n, edge_cap, mode, shards=shards))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    sent = REGISTRY.get("shard.all_to_all.bytes")
    with force_multiword() if multiword else contextlib.nullcontext():
        out, stats = engine.run(edbs)
    torch.cuda.synchronize()
    counts = launch_counts()
    sent = REGISTRY.get("shard.all_to_all.bytes") - sent
    rel = OUTPUT[name]
    per_shard = [int(x) for x in engine.last_env[(rel, "full")].n]
    engine.close()
    del engine
    label = (f"{label}{' (force_multiword)' if multiword else ''}, "
             f"{shards} shards, {mode} mode")
    edge_send = shards * pow2_cap(len(edbs["edge"])) * edbs["edge"].shape[
        1] * 4
    wall = (f"; unsharded host mode {unsharded.wall_s:.4f} s"
            if unsharded is not None else "")
    print(f"{label}: wall {stats.wall_s:.4f} s{wall}; iterations "
          f"{stats.iterations}, grow_retries {stats.grow_retries}; {rel} "
          f"rows per shard {per_shard}; all-to-all {sent} B a shard "
          f"({shards * sent} B over the shards; the edge relation's send "
          f"buffer {edge_send} B a shard, {shards * edge_send} B over the "
          f"shards); peak memory {torch.cuda.max_memory_allocated()} B "
          f"allocated, {torch.cuda.max_memory_reserved()} B reserved; "
          f"launches {counts}", flush=True)
    if stats.grow_retries:
        raise AssertionError(f"{label}: {stats.grow_retries} grow retries")
    hold_facts(np, label, out[rel], want)
    if unsharded is not None:
        if (out[rel].dtype != unsharded.facts.dtype
                or out[rel].tobytes() != unsharded.facts.tobytes()):
            raise AssertionError(f"{label}: facts differ from the "
                                 f"unsharded run's bytes")
        if stats.iterations != unsharded.iterations:
            raise AssertionError(
                f"{label}: iterations {stats.iterations} differ from the "
                f"unsharded run's {unsharded.iterations}")
        print(f"{label}: facts and iterations equal the unsharded host-"
              f"mode run's byte for byte", flush=True)
    return counts, stats


def run_sharded(torch, seed, n, edge_cap, runs, host, edges, edge_keys,
                source):
    """Phase sharded: (a) Reach, CC and SSSP at ``SHARDS`` shards on the
    engine phase's graph in host mode, each held to scipy and to the
    unsharded host-mode run (``host``); (b) Reach and Reach under
    force_multiword() at ``SHARDS_WIDE`` shards on a Graph500 graph of
    scale ``SHARD_SCALE``, in host and in device mode, held the same way
    and device mode to host mode's iterations; (c) Reach (DRed) and CC
    (recompute) maintained at ``SHARDS`` shards under one seeded batch of
    SHARD_BATCH new and SHARD_BATCH deleted edges, the state equal to the
    unsharded IncrementalEngine's and to a batch run over the edge set
    kept apart; (d) durable snapshots of the launcher's program at
    SHARD_SCALE cross-loaded from 2 shards into one and back, each
    restore counting ``resilience.restore.rehomed`` and giving the
    writer's view. Returns the sharded engines' launch counts."""
    import numpy as np
    from repro_torch.launch.fixpoint import EDGE_FACTOR, kronecker_edges
    counted: dict = {}
    # (a)
    for name, text, edbs, want, mw in runs[:3]:
        counts, _ = run_sharded_engine(
            torch, name, name, text, edbs, n, edge_cap, want, SHARDS,
            unsharded=host[name, mw])
        add_counts(counted, counts)
    # (b)
    n20 = 1 << SHARD_SCALE
    src, dst, _ = kronecker_edges(SHARD_SCALE, EDGE_FACTOR, seed)
    source20 = int(np.argmax(np.bincount(src, minlength=n20)))
    keys20 = sorted_unique(src.astype(np.int64) << 32 | dst)
    x, y = (keys20 >> 32).astype(np.int32), (keys20 & 0xFFFFFFFF).astype(
        np.int32)
    import scipy.sparse as sp
    g = sp.csr_matrix((np.ones(len(keys20)), (x, y)), shape=(n20, n20))
    want20, _ = reach_and_cc(g, n20, x, y, source20)
    edbs20 = {"edge": np.stack([src, dst], axis=1),
              "source": np.array([[source20]])}
    text = runs[0][1]
    cap20 = EDGE_FACTOR * n20
    print(f"sharded: graph of scale {SHARD_SCALE}, {n20} vertices, "
          f"{len(src)} directed edges, source {source20}, {len(want20)} "
          f"reached (scipy)", flush=True)
    for mw in (False, True):
        _, one = run_engine(torch, "Reach", text, edbs20, n20, cap20,
                            want20, mw, title=f"Reach at scale "
                            f"{SHARD_SCALE}, unsharded")
        modes = {}
        for mode in ("host", "device"):
            counts, modes[mode] = run_sharded_engine(
                torch, f"Reach at scale {SHARD_SCALE}", "Reach", text,
                edbs20, n20, cap20, want20, SHARDS_WIDE, mode, mw, one)
            add_counts(counted, counts)
        if modes["device"].iterations != modes["host"].iterations:
            raise AssertionError("sharded device mode's iterations differ "
                                 "from host mode's")
    # (c)
    add_counts(counted, run_sharded_incremental(
        torch, seed, n, edge_cap, edges, edge_keys, source))
    # (d)
    add_counts(counted, run_sharded_durable(
        torch, seed, n20, cap20, edbs20["edge"], keys20, source20))
    print(f"sharded: launches {counted}", flush=True)
    return counted


def run_sharded_incremental(torch, seed, n, edge_cap, edges, edge_keys,
                            source):
    """Reach and CC maintained at SHARDS shards in host mode under one
    seeded batch of SHARD_BATCH new and SHARD_BATCH deleted edges: the
    state after initialize and after the apply byte-equal to the
    unsharded IncrementalEngine's (iterations too), and to a batch run
    over the edge set kept apart; the edge mirror equal to that set.
    Prints initialize and apply s of both beside the batch run's.
    Returns the sharded engine's launch counts."""
    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, Observation, make_engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.fixpoint import CC, REACH, engine_config
    counted: dict = {}
    cap = edge_cap + SHARD_BATCH
    for name, text in (("Reach", REACH), ("CC", CC)):
        rng = np.random.default_rng((seed, 23, len(name)))
        ins = new_edges(np, rng, edge_keys, n, SHARD_BATCH)
        dele = some_edges(np, rng, edge_keys, SHARD_BATCH)
        srt = np.sort(ins)
        keys = np.insert(edge_keys, np.searchsorted(edge_keys, srt), srt)
        keys = np.delete(keys, np.searchsorted(keys, dele))
        edbs = {"edge": edges}
        if name == "Reach":
            edbs["source"] = np.array([[source]])
        cp = compile_program(text)
        states = {}
        for shards in (SHARDS, 0):
            obs = Observation()
            inc = make_engine(cp, engine_config(n, cap, "host", obs,
                                                shards=shards),
                              incremental=True)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            first = inc.initialize(edbs)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            snap = inc.apply(inserts={"edge": edge_rows(np, ins)},
                             deletes={"edge": edge_rows(np, dele)})
            torch.cuda.synchronize()
            apply_s = time.perf_counter() - t0
            if shards:
                add_counts(counted, launch_counts())
            mirror = inc.edbs["edge"].astype(np.int64)
            if not np.array_equal(mirror[:, 0] << 32 | mirror[:, 1], keys):
                raise AssertionError(f"sharded incremental {name}: the "
                                     f"edge mirror differs from the edge set")
            strategies = [(sp_.attrs["key"], sp_.attrs["strategy"])
                          for sp_ in obs.find("maintain-stratum")]
            print(f"incremental {name}, {shards or 1} shard(s): initialize "
                  f"{init_s:.4f} s, apply (+{SHARD_BATCH} -{SHARD_BATCH} "
                  f"edges) {apply_s:.4f} s, strategies {strategies}, "
                  f"iterations {inc._stats.iterations}; peak memory "
                  f"{torch.cuda.max_memory_allocated()} B allocated, "
                  f"{torch.cuda.max_memory_reserved()} B reserved",
                  flush=True)
            states[shards] = (first, snap, dict(inc._stats.iterations))
            if shards:
                inc.engine.close()
            del inc, first, snap
        for when in (0, 1):
            a, b = states[SHARDS][when], states[0][when]
            if a.keys() != b.keys() or any(
                    a[k].dtype != b[k].dtype or a[k].tobytes()
                    != b[k].tobytes() for k in a):
                raise AssertionError(
                    f"sharded incremental {name}: the state after "
                    f"{('initialize', 'the apply')[when]} differs from the "
                    f"unsharded engine's")
        if states[SHARDS][2] != states[0][2]:
            raise AssertionError(f"sharded incremental {name}: iterations "
                                 f"differ from the unsharded engine's")
        out, stats = Engine(cp, engine_config(n, cap, "host")).run(
            {**edbs, "edge": edge_rows(np, keys)})
        snap = states[SHARDS][1]
        for rel in out:
            if not np.array_equal(snap[rel], out[rel]):
                raise AssertionError(f"sharded incremental {name}: {rel} "
                                     f"differs from the batch run")
        print(f"incremental {name}, {SHARDS} shards: the state equals the "
              f"unsharded engine's byte for byte after initialize and "
              f"apply, iterations too, and a batch run over the edge set "
              f"kept apart ({stats.wall_s:.4f} s)", flush=True)
        del states, out
    return counted


def run_sharded_durable(torch, seed, n, edge_cap, edges, edge_keys, source):
    """The launcher's program at SHARD_SCALE in host mode, durable: an
    engine at SHARDS shards initializes and applies one batch (+4096
    -4096 links), and its snapshot and WAL recover into an unsharded
    engine; an unsharded engine does the same, and its recover into one
    at SHARDS shards. Each restore counts resilience.restore.rehomed once
    and gives the writer's view. Returns the sharded engines' launch
    counts."""
    import shutil

    import numpy as np
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import (
        DurableIncrementalEngine, EngineConfig, Observation,
        ResilienceConfig,
    )
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import incremental_serving
    cp = compile_program(incremental_serving.PROGRAM)
    rng = np.random.default_rng((seed, 29))
    quarantined = rng.choice(n, size=n // 100, replace=False)
    quarantined = np.sort(quarantined[quarantined != source])
    edbs = {"link": edges, "monitor": np.array([[source]]),
            "quarantined": quarantined[:, None]}
    k = 1 << 12
    batch = dict(inserts={"link": edge_rows(np, new_edges(
        np, rng, edge_keys, n, k))},
        deletes={"link": edge_rows(np, some_edges(np, rng, edge_keys, k))})
    root = ROOT / "build" / "sharded"
    shutil.rmtree(root, ignore_errors=True)
    counted: dict = {}

    def config(shards, obs=None):
        return EngineConfig(idb_cap=n, intermediate_cap=edge_cap + k,
                            mode="host", observe=obs, shards=shards)

    views = {}
    for writer, reader in ((SHARDS, 0), (0, SHARDS)):
        reset_launch_counts()
        dur = DurableIncrementalEngine(
            cp, config(writer), directory=root / f"w{writer}",
            resilience=ResilienceConfig(snapshot_every=1))
        dur.initialize(edbs)
        out = dur.apply(**batch)
        dur.close()
        views[writer] = {r: out[r] for r in ("reaches", "pathlen")}
        if writer:
            dur.engine.close()
            add_counts(counted, launch_counts())
        del dur
        d = root / f"w{writer}-r{reader}"
        shutil.copytree(root / f"w{writer}", d)
        obs = Observation()
        reset_launch_counts()
        cold = DurableIncrementalEngine(cp, config(reader, obs),
                                        directory=d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cold.recover()
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        if reader:
            cold.engine.close()
            add_counts(counted, launch_counts())
        hold_view(np, f"durable cross-load {writer or 1} -> {reader or 1} "
                  f"shard(s)", got, views[writer])
        rehomed = obs.registry.get("resilience.restore.rehomed")
        if rehomed != 1:
            raise AssertionError(f"durable cross-load: rehomed {rehomed}")
        print(f"durable cross-load: a snapshot of {writer or 1} shard(s) "
              f"(+{k} -{k} links applied) recovered by an engine of "
              f"{reader or 1} in {rec_s:.4f} s, rehomed {rehomed}, its "
              f"view ({len(got['reaches'])} hosts reached) the writer's",
              flush=True)
        cold.close()
        del cold, got
    hold_view(np, "durable: the sharded writer's view against the "
              "unsharded writer's", views[SHARDS], views[0])
    shutil.rmtree(root, ignore_errors=True)
    return counted


# -- attention kernels and the LM serving path --------------------------------

BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor peak, data sheet
TF32_FLOPS_PER_S = 495e12    # dense TF32 tensor peak, data sheet
F32_FLOPS_PER_S = 67e12      # float32 outside the tensor cores, data sheet
TF32_PASSES = 3              # the float32 prefill's products, 3xTF32
# (rtol, atol). The kernels and their plain versions compute in float32
# and round once to the output's dtype (the bf16 kernel feeds P to P.V as
# bfloat16 hi + lo parts, exact to about 2**-16 of each p; the f32 kernel
# splits every operand into TF32 hi + lo parts, about 22 bits), so
# bfloat16 outputs differ by about one unit in the last place: 2**-7 of
# the value at worst.
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-4)}


def attention_work(q, k, causal=True, kv_len=None):
    """(flops, bytes) that attention needs on these inputs: 4 d flops per
    visible (query, key) pair (QK^T and PV), q, k and v read once and the
    output written once; for decode only the valid K/V rows count."""
    import numpy as np
    b, hq, d = q.shape[0], q.shape[1], q.shape[-1]
    hkv, skv = k.shape[1], k.shape[2]
    es = q.element_size()
    if kv_len is None:
        sq = q.shape[2]
        if causal:   # row i sees min(skv, max(0, i + skv - sq + 1)) keys
            rows = np.arange(sq, dtype=np.int64) + (skv - sq + 1)
            visible = int(np.clip(rows, 0, skv).sum())
        else:
            visible = sq * skv
        return 4 * d * b * hq * visible, (2 * q.numel() + 2 * k.numel()) * es
    total = int(kv_len.clamp(0, skv).sum())
    return 4 * d * hq * total, (2 * q.numel() + 2 * hkv * total * d) * es


def attention_bound(q, k, causal=True, kv_len=None):
    """(bound ms, 'bytes' or 'operations'): the larger of the byte time
    at 3.35 TB/s and the flop time of the kernel's route: bf16 at the
    bf16 tensor peak, the float32 prefill's three TF32 products at the
    TF32 peak, the decode (CUDA cores) at the f32 peak."""
    flops, nbytes = attention_work(q, k, causal, kv_len)
    if str(q.dtype).endswith("bfloat16"):
        t_ops = flops / BF16_FLOPS_PER_S
    elif kv_len is None:
        t_ops = TF32_PASSES * flops / TF32_FLOPS_PER_S
    else:
        t_ops = flops / F32_FLOPS_PER_S
    t_ops, t_bytes = t_ops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def sdpa(torch, q, k, v, causal=True, kv_len=None):
    """The library yardstick: one scaled_dot_product_attention call on
    the same inputs (GQA without repeat; never called by the port)."""
    F = torch.nn.functional
    if kv_len is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)
    pos = torch.arange(k.shape[2], device=q.device)
    mask = (pos[None, :] < kv_len[:, None].long())[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def check_attention(torch, label, q, k, v, causal=True, kv_len=None,
                    timed=True, library=True):
    """The kernel against its plain version on the same inputs, within
    ATTN_TOL; with ``timed``, CUDA-event times of the kernel, the plain
    version and SDPA beside the bound."""
    from repro_torch.kernels import flash_attention as FA
    if kv_len is None:
        label += f" [{FA.prefill_kernel(q.dtype)} kernel]"
        kernel = functools.partial(FA.flash_attention, q, k, v, causal)
        plain = functools.partial(FA.flash_attention_plain, q, k, v, causal)
    else:
        kernel = functools.partial(FA.flash_decode, q, k, v, kv_len)
        plain = functools.partial(FA.flash_decode_plain, q, k, v, kv_len)
    out, want = kernel().float(), plain().float()
    torch.cuda.synchronize()
    if kv_len is not None and not torch.equal(out, kernel().float()):
        raise AssertionError(f"{label}: a second decode call gave other "
                             f"bits")
    rtol, atol = ATTN_TOL[str(q.dtype).split(".")[-1]]
    err = float((out - want).abs().max())
    tol = (f"max |want| {float(want.abs().max())}, rtol {rtol} atol "
           f"{atol}")
    torch.testing.assert_close(out, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{label}: {m}")
    if not timed:
        print(f"{label}: max abs err {err} ({tol})", flush=True)
        return dict(max_abs_err=err)
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, plain, reps=2, warmup=1)
    library_ms = (cuda_ms(torch, lambda: sdpa(torch, q, k, v, causal, kv_len))
                  if library else None)
    b_ms, bound_by = attention_bound(q, k, causal, kv_len)
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=bound_by, library_ms=library_ms)
    extra = ""
    if kv_len is not None:   # short enough for the host to pace it
        out["host_paced_ms"] = cuda_ms(torch, kernel, lead=False)
        extra = f" (at the host's launch rate {out['host_paced_ms']:.4f} ms)"
    elif q.dtype == torch.float32:   # the ceiling of a CUDA-core kernel,
        flops, _ = attention_work(q, k, causal)     # printed, not returned
        extra = f" (f32 FMA bound {flops / F32_FLOPS_PER_S * 1e3:.4f} ms)"
    print(f"{label}: max abs err {err} ({tol}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {library_ms} ms, bound {b_ms:.4f} ms by "
          f"{bound_by} ({100 * b_ms / ms:.1f}% of it){extra}", flush=True)
    return out


def ptxas_lines(report: str) -> dict:
    """{kernel entry: its ptxas register, barrier and spill lines} from
    nvcc's -Xptxas -v output."""
    entries, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entries[name] = []
        elif name and ("registers" in line or "spill" in line):
            entries[name].append(line.split(":", 1)[-1].strip())
    return entries


def run_attention_checks(torch, seed, dev):
    """The attention kernels at the model's shapes: qwen3-1.7b prefill
    (hq 16, hkv 8, d 128) at 4096 tokens, gemma's d = 256 and chatglm3's
    GQA 16:1, each in bf16 and f32, a chunk of 1000 queries at the end of
    4096 keys, and decode over a 32768-position cache with ragged
    lengths."""
    import re
    from repro_torch.kernels import _build
    for source, kernel in (("flash_attention_wgmma", "attn_wgmma_kernel"),
                           ("flash_attention_tf32", "attn_tf32_kernel")):
        for entry, lines in ptxas_lines(_build.report(source)).items():
            if kernel in entry:
                d = re.search(r"ILi(\d+)E", entry)
                print(f"ptxas {kernel}<{d.group(1) if d else '?'}>: "
                      + "; ".join(lines), flush=True)
    for entry, lines in ptxas_lines(
            _build.report("flash_attention")).items():
        t = re.search(r"decode_split_kernelI(f|13__nv_bfloat16)"
                      r"Li(\d+)ELi(\d+)E", entry)
        if t:
            dtype = "float" if t.group(1) == "f" else "bf16"
            print(f"ptxas decode_split_kernel<{dtype}, d={t.group(2)}, "
                  f"heads/warp={t.group(3)}>: " + "; ".join(lines),
                  flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    for dtype in (bf16, f32):
        q = rnd((1, 16, 4096, 128), dtype)
        k, v = rnd((1, 8, 4096, 128), dtype), rnd((1, 8, 4096, 128), dtype)
        check_attention(torch, f"flash_attention {str(dtype)[6:]} b=1 hq=16 "
                        f"hkv=8 sq=skv=4096 d=128 causal", q, k, v)
    # SDPA's causal mask is top-left aligned: no yardstick when sq < skv
    q = rnd((1, 16, 1000, 128), bf16)
    k, v = rnd((1, 8, 4096, 128), bf16), rnd((1, 8, 4096, 128), bf16)
    check_attention(torch, "flash_attention bfloat16 chunk sq=1000 "
                    "skv=4096 causal", q, k, v, library=False)
    for dtype in (bf16, f32):
        name = str(dtype)[6:]
        q, k, v = (rnd((1, 16, 1024, 256), dtype) for _ in range(3))
        check_attention(torch, f"flash_attention {name} gemma d=256 "
                        f"hq=hkv=16 sq=skv=1024 causal", q, k, v)
        q = rnd((1, 32, 1024, 128), dtype)
        k, v = rnd((1, 2, 1024, 128), dtype), rnd((1, 2, 1024, 128), dtype)
        check_attention(torch, f"flash_attention {name} chatglm3 GQA 16:1 "
                        f"sq=skv=1024 causal", q, k, v)
    S = 32768
    kv_len = torch.tensor([1, 10923, 32767, 32768] * 2, dtype=torch.int32,
                          device=dev)
    for dtype in (bf16, f32):
        q = rnd((8, 16, 128), dtype)
        k, v = rnd((8, 8, S, 128), dtype), rnd((8, 8, S, 128), dtype)
        check_attention(torch, f"flash_decode {str(dtype)[6:]} b=8 hq=16 "
                        f"hkv=8 S=32768 kv_len {{1, 10923, 32767, 32768}}",
                        q, k, v, kv_len=kv_len)
        del q, k, v


@contextlib.contextmanager
def attention_swapped(FA, flash_attention, flash_decode):
    """Route the model's attention calls through other functions."""
    saved = FA.flash_attention, FA.flash_decode
    FA.flash_attention, FA.flash_decode = flash_attention, flash_decode
    try:
        yield
    finally:
        FA.flash_attention, FA.flash_decode = saved


@contextlib.contextmanager
def attention_captured(FA, layers, gen_tokens):
    """Route the model's attention through the kernels and keep clones of
    the first and last layer's inputs at the prefill and at the last
    decode step: yields {(kind, layer): inputs}."""
    keep = (0, layers - 1)
    captured = {}
    calls = {"prefill": 0, "decode": 0}
    kernel_fa, kernel_fd = FA.flash_attention, FA.flash_decode

    def fa(q, k, v, causal=True):
        i = calls["prefill"]
        calls["prefill"] += 1
        out = kernel_fa(q, k, v, causal=causal)
        if i in keep:
            captured[("prefill", i)] = (q.clone(), k.clone(), v.clone())
        return out

    def fd(q, k, v, kv_len):
        step, layer = divmod(calls["decode"], layers)
        calls["decode"] += 1
        out = kernel_fd(q, k, v, kv_len)
        if step == gen_tokens - 1 and layer in keep:
            captured[("decode", layer)] = (q.clone(), k.clone(), v.clone(),
                                           kv_len.clone())
        return out

    with attention_swapped(FA, fa, fd):
        yield captured


def check_captured(torch, captured, prefix, in_f32=False):
    """The kernels against their plain versions on captured attention
    inputs; layer 0's are timed. With ``in_f32``, bf16 inputs are also
    checked cast to float32 (untimed). Returns the measured numbers per
    kernel, the worst error over both layers."""
    from repro_torch.kernels import flash_attention as FA
    measured = {}
    for (kind, layer), args in sorted(captured.items()):
        qkv, kv_len = args[:3], (args[3] if kind == "decode" else None)
        name = ("flash_decode" if kind == "decode" else
                "flash_attention_wgmma" if qkv[0].dtype == torch.bfloat16
                else "flash_attention")
        label = (f"{prefix} {kind} layer {layer}: "
                 f"{list(args[0].shape)} over {list(args[1].shape)}")
        r = check_attention(torch, label, *qkv, kv_len=kv_len,
                            timed=layer == 0)
        if in_f32:
            check_attention(torch, label + " in float32",
                            *(t.float() for t in qkv), kv_len=kv_len,
                            timed=False)
        if name not in measured:
            measured[name] = r
        else:
            measured[name]["max_abs_err"] = max(
                measured[name]["max_abs_err"], r["max_abs_err"])
    return measured


# -- the MoE layer ---------------------------------------------------------

# the router's float32 product sums d = 1536 terms in a row, partial
# sums of a few units: a random walk of sqrt(d) roundings of up to 2**-23
# each, a few 1e-6 in the logits; this bounds it
ROUTER_ATOL = 1e-5
# a token whose float64 p_(k) - p_(k+1) is below this may take another
# expert set on the card: a logit error of ROUTER_ATOL moves a
# probability p by p * 1e-5, under 1e-5
MOE_MARGIN = 1e-5


@contextlib.contextmanager
def moe_captured(M, layers, gen_tokens):
    """Keep a clone of the MoE input of the first and last layer, with
    that layer's weights, at the prefill and at the last decode step:
    yields {(kind, layer): (weights, x)}. The calls still go to
    ``moe_ffn``."""
    keep = (0, layers - 1)
    captured, calls = {}, [0]
    ffn = M.moe_ffn

    def wrapped(params, x, cfg, groups=1):
        step, layer = divmod(calls[0], layers)
        calls[0] += 1
        if layer in keep and step in (0, gen_tokens):
            captured[("prefill" if step == 0 else "decode", layer)] = (
                params, x.clone())
        return ffn(params, x, cfg, groups)

    M.moe_ffn = wrapped
    try:
        yield captured
    finally:
        M.moe_ffn = ffn


def top_k_margin(torch, probs, k):
    """p_(k) - p_(k+1) of each row of ``probs`` (inf when k is every
    expert): how far a token's expert set is from another."""
    if k == probs.shape[-1]:
        return torch.full_like(probs[..., 0], math.inf)
    ranked = probs.sort(-1, descending=True).values
    return ranked[..., k - 1] - ranked[..., k]


def renormalised(probs, top_e):
    """``probs`` at the experts ``top_e``, renormalised as ``route``
    renormalises its top-k."""
    p = probs.gather(-1, top_e)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-9)


def check_moe_layer(torch, label, params, x, cfg, groups, timed=False):
    """One MoE layer on the card (x [T, d] and the layer's weights, in
    their dtype) against a float64 run of ``moe_ffn``'s pieces on the
    host, on float64 copies:
    - expert sets equal for every token whose float64 margin p_(k) -
      p_(k+1) is at least MOE_MARGIN (the others may flip);
    - the router's float32 logits within ROUTER_ATOL of float64's;
    - slots and keep equal to a float64 dispatch of the card's own
      expert choices; gates within twice the largest logit error
      relative (a renormalised softmax moves by at most that) plus
      float32's rounding, and plus bfloat16's in bfloat16;
    - the output within 2e-2 of its scale of the float64 output with the
      card's routing, and within 1e-4 with the input and weights cast to
      float32.
    The card's calls run under sync debug mode "error": none may read the
    device from the host. Returns the dropped share, and with ``timed``
    the CUDA-event times of routing plus dispatch and of the layer."""
    from repro_torch.models import moe as M
    t, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    g, tg, cap = M.group_plan(t, groups, cfg)
    p32 = {n: w.float() for n, w in params.items()}
    x32 = x.float()

    def card(p, xx):
        _, top_p, top_e = M.route(p["router"], xx.reshape(g, tg, d), k)
        return top_e, M.dispatch(top_p, top_e, e, cap, xx.dtype)

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = M.moe_ffn(params, x, cfg, groups)
        top_e, (slot, keep, gates) = card(params, x)
        y32, _ = M.moe_ffn(p32, x32, cfg, groups)
        top_e32, (slot32, keep32, gates32) = card(p32, x32)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    h64 = {n: w.double().cpu() for n, w in params.items()}
    x64 = x.double().cpu()
    probs64, _, want_e = M.route(h64["router"], x64.reshape(g, tg, d), k)
    logit_err = float((x32 @ p32["router"]).cpu().double().sub(
        x64 @ h64["router"]).abs().max())
    if logit_err > ROUTER_ATOL:
        raise AssertionError(f"{label}: router logits off float64 by "
                             f"{logit_err}")
    margin = top_k_margin(torch, probs64, k)
    got_e = top_e.cpu()
    differ = (got_e.sort(-1).values != want_e.sort(-1).values).any(-1)
    near = margin < MOE_MARGIN
    bad = differ & ~near
    if bool(bad.any()):
        raise AssertionError(
            f"{label}: expert sets differ from float64 at {int(bad.sum())} "
            f"tokens of margin >= {MOE_MARGIN} (smallest "
            f"{float(margin[bad].min())})")
    if not torch.equal(top_e32, top_e):
        raise AssertionError(f"{label}: the float32 cast routed otherwise "
                             f"than the same router product in {x.dtype}")
    p64 = renormalised(probs64, got_e)
    slot64, keep64, gates64 = M.dispatch(p64, got_e, e, cap, torch.float64)
    gate_rel = {}
    for name, (sl, kp, ga) in {str(x.dtype): (slot, keep, gates),
                               "float32": (slot32, keep32, gates32)}.items():
        if not (torch.equal(sl.cpu(), slot64)
                and torch.equal(kp.cpu(), keep64)):
            raise AssertionError(f"{label}: {name} slots or keep differ "
                                 f"from the float64 dispatch")
        rounding = 2.0 ** -8 if ga.dtype == torch.bfloat16 else 0.0
        rel = 2 * logit_err + 2.0 ** -21 + rounding
        gerr = (ga.cpu().double() - gates64).abs()
        gate_rel[name] = float((gerr / gates64.abs().clamp_min(1e-30))
                               .max())
        if bool((gerr > rel * gates64.abs() + 1e-12).any()):
            raise AssertionError(f"{label}: {name} gates off the float64 "
                                 f"ones by {gate_rel[name]} relative, "
                                 f"over {rel}")
    y64 = M.mix(h64, x64, p64, got_e, cfg, cap)
    aux64 = float(M.load_balance(probs64, got_e, e))
    scale = float(y64.abs().max())
    err = float((y.cpu().double() - y64).abs().max())
    err32 = float((y32.cpu().double() - y64).abs().max())
    dropped = 1.0 - float(keep64.double().mean())
    print(f"{label}: T {t} in {g} groups of {tg}, capacity {cap}; "
          f"{int(near.sum())} tokens of float64 margin < {MOE_MARGIN}, "
          f"{int(differ.sum())} expert sets differ from float64; router "
          f"logits off by {logit_err}, gates by {gate_rel} relative; "
          f"dropped {dropped} of {t * k} assignments; y max abs err {err} "
          f"({x.dtype}), {err32} (float32) of scale {scale}; aux "
          f"{float(aux)} against {aux64}", flush=True)
    if not (err <= (2e-2 if x.dtype == torch.bfloat16 else 1e-4) * scale
            and err32 <= 1e-4 * scale):
        raise AssertionError(f"{label}: the output is off the float64 one")
    if abs(float(aux) - aux64) > 1e-4 * abs(aux64):
        raise AssertionError(f"{label}: aux {float(aux)} against {aux64}")
    out = dict(dropped=dropped)
    if timed:
        out["dispatch_ms"] = cuda_ms(torch, lambda: card(params, x))
        out["layer_ms"] = cuda_ms(torch, lambda: M.moe_ffn(params, x, cfg,
                                                           groups))
        print(f"{label}: routing + dispatch {out['dispatch_ms']:.4f} ms, "
              f"the layer {out['layer_ms']:.4f} ms", flush=True)
    return out


@contextlib.contextmanager
def moe_routing(torch, M, replay=None):
    """Without ``replay``: record each MoE call's expert choices, yielding
    the list. With ``replay`` (such a list from an earlier run): each call
    routes to the recorded experts, its gates its own probabilities at
    them, renormalised; yields a list of (call, tokens whose own expert
    set differs, their float32 margins p_(k) - p_(k+1))."""
    ffn = M.moe_ffn
    log = []

    def record(params, x, cfg, groups=1):
        t, d = x.shape
        g, tg, _ = M.group_plan(t, groups, cfg)
        log.append(M.route(params["router"], x.reshape(g, tg, d),
                           cfg.top_k)[2])
        return ffn(params, x, cfg, groups)

    def replayed(params, x, cfg, groups=1):
        t, d = x.shape
        g, tg, cap = M.group_plan(t, groups, cfg)
        probs, _, own = M.route(params["router"], x.reshape(g, tg, d),
                                cfg.top_k)
        forced = replay[len(log)]
        differ = (own.sort(-1).values != forced.sort(-1).values).any(-1)
        margin = top_k_margin(torch, probs, cfg.top_k)
        log.append((len(log), differ.nonzero().tolist(),
                    margin[differ].tolist()))
        y = M.mix(params, x, renormalised(probs, forced), forced, cfg, cap)
        return y, M.load_balance(probs, forced, cfg.n_experts)

    M.moe_ffn = record if replay is None else replayed
    try:
        yield log
    finally:
        M.moe_ffn = ffn


def check_moe_float32(torch, model, prompts, tag):
    """The float32 end to end of a MoE model: 2 x 96 prompt tokens and 2
    greedy steps through the kernels and again through the plain
    attention. In float32 and not bfloat16, because routing is discrete:
    a bfloat16 rounding difference (about 4e-3) between the kernels and
    the plain versions flips a few percent of the tokens' expert choices
    a layer, and a flip changes the token's output by its gate times the
    difference of two experts. In float32 the attention outputs differ by
    about 1e-6, which still flips a choice where the k-th and (k+1)-th
    probabilities nearly tie; so the plain run takes the kernel run's
    recorded expert choices (gates from its own probabilities), every
    token whose own choice differs must have a float32 margin under
    MOE_MARGIN, and then the greedy tokens must be equal and the logits
    within 1e-3 of their scale."""
    import numpy as np
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.models import moe as M
    short = prompts[:2, :96]
    with moe_routing(torch, M) as recorded:
        a = serve.generate(model, short, 2)
    with attention_swapped(FA, FA.flash_attention_plain,
                           FA.flash_decode_plain), \
            moe_routing(torch, M, replay=recorded) as differing:
        b = serve.generate(model, short, 2)
    flips = [(call, tokens, margins) for call, tokens, margins in differing
             if tokens]
    vocab = model.cfg.vocab     # not the padded entries' -1e30
    diff = float((a.logits - b.logits)[:, :vocab].abs().max())
    scale = float(b.logits[:, :vocab].abs().max())
    print(f"{tag} float32 (2 x 96 tokens, 2 steps): tokens "
          f"{a.tokens.tolist()} vs plain {b.tokens.tolist()}, logits max "
          f"abs diff {diff} of scale {scale}; expert choices the plain run "
          f"would have changed (call, tokens, float32 margins): {flips}",
          flush=True)
    wide = [m for _, _, margins in flips for m in margins
            if m >= MOE_MARGIN]
    if wide:
        raise AssertionError(f"{tag} float32: the plain run routes "
                             f"otherwise at margins {wide}")
    if not (np.array_equal(a.tokens, b.tokens) and diff <= 1e-3 * scale):
        raise AssertionError(f"{tag} float32: kernels and plain versions "
                             f"disagree")


def run_serve_phase(torch, seed, requests=8, prompt_len=2048,
                    gen_tokens=64, arch="qwen3-1.7b", smoke=False,
                    device="cuda", profile=False):
    """``arch`` at full width (``smoke`` False) through
    repro_torch.launch.serve: random bf16 weights from ``seed``,
    ``requests`` prompts of ``prompt_len`` tokens, ``gen_tokens`` greedy
    tokens. A first run captures the attention inputs of the first and
    last layer at the prefill and at the last decode step (and a MoE
    model's MoE inputs there); a second run, with nothing wrapped, is the
    timed and counted one and must give the same tokens. The kernels'
    outputs on the captured inputs are held against the plain versions,
    in bf16 and again in f32, and the MoE layers against float64
    (``check_moe_layer``). Then a dense model's short run through the
    kernels is held against the same run through the plain versions in
    bf16; a MoE model's in float32 (``check_moe_float32``), with the same
    weights cast. Returns (launch counts of the timed run, measured
    numbers per kernel at the captured shapes)."""
    import dataclasses
    import numpy as np
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    model, cfg = serve.build(arch, smoke, device, seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    tag = "serve" if cfg.moe is None else cfg.name
    ffn = (f"d_ff {cfg.d_ff}" if cfg.moe is None else
           f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff}, {cfg.moe_groups} groups")
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, {ffn}, vocab "
          f"{cfg.vocab}; {n_params} parameters in {cfg.dtype} from seed "
          f"{seed} in {time.perf_counter() - t0:.3f} s", flush=True)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(requests, prompt_len))
    L, cap = cfg.n_layers, prompt_len + gen_tokens
    moe_inputs = (moe_captured(M, L, gen_tokens) if cfg.moe
                  else contextlib.nullcontext({}))
    with attention_captured(FA, L, gen_tokens) as captured, \
            moe_inputs as moe_in:
        g = serve.generate(model, prompts, gen_tokens)
    steps = g.registry.percentiles("serve.decode_step_s")
    print(f"{tag}, capturing run: prefill_s {g.prefill_s}, decode step "
          f"p50 {steps['p50'] * 1e3} ms, p99 {steps['p99'] * 1e3} ms",
          flush=True)
    captured_tokens = g.tokens
    del g
    measured = check_captured(torch, captured, tag, in_f32=True)
    captured.clear()
    for (kind, layer), (params, x) in sorted(moe_in.items()):
        check_moe_layer(torch, f"{tag} MoE {kind} layer {layer}", params, x,
                        cfg.moe, cfg.moe_groups, timed=layer == 0)
        if profile and kind == "decode" and layer == 0:
            profile_run(torch, f"{tag} one MoE layer at decode", lambda: (
                M.moe_ffn(params, x, cfg.moe, cfg.moe_groups)), moe=True)
    moe_in.clear()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    g = serve.generate(model, prompts, gen_tokens)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = g.registry.percentiles("serve.decode_step_s")
    print(f"{tag}: {serve.summary(g, requests, gen_tokens)}")
    print(f"{tag} (unrounded): prefill_s {g.prefill_s}, decode_s "
          f"{g.decode_s}, decode step p50 {steps['p50'] * 1e3} ms, p99 "
          f"{steps['p99'] * 1e3} ms, tokens/s "
          f"{requests * gen_tokens / g.decode_s}, prefill tokens/s "
          f"{requests * prompt_len / g.prefill_s}, peak device memory "
          f"{peak} B, launches {counts}", flush=True)
    want = {"flash_attention_wgmma": L, "flash_attention_tf32": 0,
            "flash_decode": L * gen_tokens,
            "flash_decode_combine": L * gen_tokens}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    if not bool(torch.isfinite(g.logits.float()).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    if not (g.tokens.shape == (requests, gen_tokens)
            and ((g.tokens >= 0) & (g.tokens < cfg.vocab)).all()):
        raise AssertionError(f"{tag}: tokens out of range {g.tokens}")
    if g.cache.length.tolist() != [cap] * requests:
        raise AssertionError(f"{tag}: cache lengths {g.cache.length}")
    if not np.array_equal(g.tokens, captured_tokens):
        raise AssertionError(f"{tag}: the capturing run gave other tokens")
    del g

    if cfg.moe is None:
        # a short run through the kernels against the same run through
        # the plain versions: the same greedy token, logits within 2e-2
        # of scale
        short = prompts[:2, :96]
        a = serve.generate(model, short, 2)
        with attention_swapped(FA, FA.flash_attention_plain,
                               FA.flash_decode_plain):
            b = serve.generate(model, short, 2)
        diff = float((a.logits.float() - b.logits.float()).abs().max())
        scale = float(b.logits.float().abs().max())
        print(f"serve reference (2 x 96 tokens, 2 steps): tokens "
              f"{a.tokens.tolist()} vs plain {b.tokens.tolist()}, logits "
              f"max abs diff {diff} of scale {scale}", flush=True)
        if not (np.array_equal(a.tokens, b.tokens) and diff <= 2e-2 * scale):
            raise AssertionError("serve: kernels and plain versions "
                                 "disagree")
        del a, b
    if profile:     # warm: the prefill, then 4 decode steps alone
        moe = cfg.moe is not None
        profile_run(torch, f"{tag} prefill", lambda: model.prefill(
            torch.as_tensor(prompts, device=model.device), capacity=cap),
            moe)
        _, cache = model.prefill(torch.as_tensor(prompts, device=model.device),
                                 capacity=cap)
        tok = torch.zeros((requests, 1), dtype=torch.int32,
                          device=model.device)

        def steps():
            c = cache
            for _ in range(4):
                _, c = model.decode_step(tok, c)
                torch.cuda.synchronize()
        profile_run(torch, f"{tag} 4 decode steps", steps, moe)
        del cache
    if cfg.moe is not None:
        # the served weights again from the seed (serve.build's draw),
        # cast to float32
        router = model.layers[0].moe_weights["router"].clone()
        del model
        torch.cuda.empty_cache()
        dev = torch.device(device)
        tree = T.tree_map(lambda w: w.float(), T.init_params(
            cfg, torch.Generator(dev).manual_seed(seed), dev))
        if not torch.equal(tree["layers"]["moe"]["router"][0],
                           router.float()):
            raise AssertionError(f"{tag}: the float32 copy is not the "
                                 f"served weights")
        model = T.Transformer(dataclasses.replace(cfg, dtype="float32"),
                              tree, device=dev)
        del tree
        check_moe_float32(torch, model, prompts, tag)
    del model
    torch.cuda.empty_cache()
    return counts, measured


F32_LAYERS, F32_REQUESTS, F32_PROMPT_LEN, F32_GEN_TOKENS = 28, 8, 2048, 8


def run_serve_f32(torch, seed, profile=False):
    """qwen3-1.7b served in float32 at full width and depth (``F32_LAYERS``
    of its 28 layers, ``F32_REQUESTS`` prompts of ``F32_PROMPT_LEN``
    tokens, ``F32_GEN_TOKENS`` greedy tokens): its prefill goes to the
    3xTF32 attention kernel. A first run captures the attention inputs
    of the first and last layer at the prefill and at the last decode
    step, and the kernels are held against their plain versions on them
    (layer 0's prefill gives the f32 kernel's numbers); the second,
    counted run must give the same greedy tokens as the first and as a
    run through the plain versions, and logits within 1e-3 of their
    scale. With ``profile``, one more prefill under torch.profiler.
    Returns (the counted run's launches, measured numbers per kernel)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer
    layers, requests = F32_LAYERS, F32_REQUESTS
    prompt_len, gen_tokens = F32_PROMPT_LEN, F32_GEN_TOKENS
    a = get_arch("qwen3-1.7b")
    cfg = dataclasses.replace(a.cfg, n_layers=layers, dtype="float32")
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serve float32: {layers} of {a.cfg.n_layers} layers, {n_params} "
          f"parameters from seed {seed} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(requests, prompt_len))
    with attention_captured(FA, layers, gen_tokens) as captured:
        first_tokens = serve.generate(model, prompts, gen_tokens).tokens
    # the decode's kernel line comes from the bf16 serve
    measured = {"flash_attention": check_captured(
        torch, captured, "serve float32")["flash_attention"]}
    captured.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    g = serve.generate(model, prompts, gen_tokens)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = g.registry.percentiles("serve.decode_step_s")
    with attention_swapped(FA, FA.flash_attention_plain,
                           FA.flash_decode_plain):
        ref = serve.generate(model, prompts, gen_tokens)
    diff = float((g.logits - ref.logits).abs().max())
    scale = float(ref.logits.abs().max())
    print(f"serve float32 ({layers} layers, {requests} x {prompt_len} "
          f"tokens, {gen_tokens} steps): prefill_s {g.prefill_s}, decode "
          f"step p50 {steps['p50'] * 1e3} ms, p99 {steps['p99'] * 1e3} ms, "
          f"prefill tokens/s {requests * prompt_len / g.prefill_s}, peak "
          f"device memory {peak} B; plain run prefill_s {ref.prefill_s}; "
          f"tokens {g.tokens.tolist()} vs plain {ref.tokens.tolist()}, "
          f"logits max abs diff {diff} of scale {scale}, launches {counts}",
          flush=True)
    want = {"flash_attention_tf32": layers, "flash_attention_wgmma": 0,
            "flash_decode": layers * gen_tokens,
            "flash_decode_combine": layers * gen_tokens}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"serve float32: launches {counts}, expected "
                             f"{want}")
    if not np.array_equal(g.tokens, first_tokens):
        raise AssertionError("serve float32: the capturing run gave other "
                             "tokens")
    if not (np.array_equal(g.tokens, ref.tokens) and diff <= 1e-3 * scale):
        raise AssertionError("serve float32: kernels and plain versions "
                             "disagree")
    del g, ref
    torch.cuda.empty_cache()
    if profile:
        tokens = torch.as_tensor(prompts, dtype=torch.int32,
                                 device=model.device)
        profile_run(torch, "serve float32 prefill", lambda: model.prefill(
            tokens, capacity=prompt_len + gen_tokens))
    del model
    torch.cuda.empty_cache()
    return counts, measured


# -- the FM recsys path -------------------------------------------------------

# the reference's kernel tests (tests/test_kernels.py): (b, f, k), one v
FM_KERNEL_SHAPES = [(32, 39, 10), (1000, 39, 10), (4096, 26, 16), (7, 13, 4)]


def fm_bound(x, v):
    """(bound ms, 'bytes'): the bytes of x and v actually read (an axis of
    stride 0 is read once) and of the output written, at 3.35 TB/s. The
    4 flops per (row, field, column) take about a twentieth of that time
    at the float32 peak, so the bytes decide."""
    def stored(t):
        return math.prod(n for n, st in zip(t.shape, t.stride()) if st)
    nbytes = (stored(x) + stored(v) + x.shape[0]) * x.element_size()
    return bound_ms(nbytes), "bytes"


def check_fm(torch, label, x, v, timed=False):
    """The kernel against its plain version on the same inputs, row by
    row within ``ref.fm_allowed_error`` (1e-5 of the cancelled terms plus
    1e-7; bfloat16 also one unit of the output); with ``timed``,
    CUDA-event times of both beside the bound (no single PyTorch call
    computes this function)."""
    from repro_torch.kernels import fm_interaction as FI, ref
    out = FI.fm_interaction(x, v)
    want = FI.fm_interaction_plain(x, v)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    allowed = ref.fm_allowed_error(x, v, want)
    max_err = float(err.max())
    worst = float((err / allowed).max())
    bad = int((err > allowed).sum())
    if bad:
        raise AssertionError(f"{label}: {bad} of {err.numel()} rows outside "
                             f"the tolerance (max abs err {max_err}, worst "
                             f"err / allowed {worst})")
    if not timed:
        print(f"{label}: max abs err {max_err}, worst err / allowed "
              f"{worst:.3g}", flush=True)
        return dict(max_abs_err=max_err)
    ms = cuda_ms(torch, lambda: FI.fm_interaction(x, v), reps=20, warmup=3)
    plain_ms = cuda_ms(torch, lambda: FI.fm_interaction_plain(x, v), reps=5,
                       warmup=1)
    b_ms, bound_by = fm_bound(x, v)
    print(f"{label}: max abs err {max_err}, worst err / allowed {worst:.3g}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"by {bound_by} ({100 * b_ms / ms:.1f}% of it)", flush=True)
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=bound_by, library_ms=None)


def run_fm_kernel_checks(torch, seed, dev, v_rows):
    """The interaction kernel at the reference's kernel-test shapes
    (N(0, 1) x and one v) and in the model's per-row form on ``v_rows``
    (a served batch's gathered factor rows, x all ones by stride 0), in
    float32 and bfloat16; the per-row float32 case is timed."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for b, f, k in FM_KERNEL_SHAPES:
        x = torch.randn((b, f), generator=gen, device=dev)
        v = torch.randn((f, k), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            check_fm(torch, f"fm_interaction {str(dtype)[6:]} shared v "
                     f"b={b} f={f} k={k}", x.to(dtype), v.to(dtype))
    b, f, k = v_rows.shape
    ones = torch.ones((1, 1), device=dev).expand(b, f)
    measured = check_fm(torch, f"fm_interaction float32 per-row v "
                        f"[{b}, {f}, {k}] (served rows)", ones, v_rows,
                        timed=True)
    check_fm(torch, "fm_interaction bfloat16 per-row v (served rows)",
             ones.bfloat16(), v_rows.bfloat16())
    return measured


def fm_reference(np, v64, w64, b64, ids):
    """float64 numpy forward with np.take(mode="clip") on host copies of
    the weights: (logits [B], scale [B] = |b| + sum_f |w_f| + the
    interaction's cancelled terms)."""
    V = np.take(v64, ids, axis=0, mode="clip")
    W = np.take(w64, ids, axis=0, mode="clip")
    S, Q = V.sum(1), (V * V).sum(1)
    logits = b64 + W.sum(-1) + 0.5 * (S * S - Q).sum(-1)
    scale = abs(b64) + np.abs(W).sum(-1) + 0.5 * (S * S + Q).sum(-1)
    return logits, scale


def retrieval_reference(np, v64, w64, b64, ctx, cand):
    """float64 numpy retrieval scores and each score's scale."""
    vc = np.take(v64, ctx, axis=0, mode="clip")
    wc = np.take(w64, ctx, axis=0, mode="clip")
    sv, s2 = vc.sum(0), (vc * vc).sum(0)
    vC = np.take(v64, cand, axis=0, mode="clip")
    wC = np.take(w64, cand, axis=0, mode="clip")
    scores = b64 + wc.sum() + 0.5 * (sv * sv - s2).sum() + wC + vC @ sv
    scale = (abs(b64) + np.abs(wc).sum() + 0.5 * (sv * sv + s2).sum()
             + np.abs(wC) + np.abs(vC * sv).sum(-1))
    return scores, scale


def hold(np, label, got, want, scale, rel=1e-5):
    """|got - want| <= rel * scale, row by row."""
    err = np.abs(np.asarray(got, np.float64) - want)
    worst = float((err / scale).max())
    print(f"{label}: max abs err {float(err.max())}, worst err / scale "
          f"{worst:.3g} (limit {rel})", flush=True)
    if not (np.isfinite(got).all() and worst <= rel):
        raise AssertionError(f"{label}: outside {rel} of the row's scale")


# the recsys phase's traffic: timed serve_p99 batches after warm-up ones,
# serve_bulk batches, retrieval_cand calls
P99_BATCHES, P99_WARMUP, BULK_BATCHES, RETRIEVAL_CALLS = 200, 10, 20, 20


def run_recsys_phase(torch, seed, profile=False):
    """The fm config on the card with weights from ``seed``: the kernel
    checks; then the counted run of serve_p99, serve_bulk and
    retrieval_cand (each timed after warm-up calls), a batch of
    out-of-range ids and embedding_bag (sum and mean), all with ids placed
    on the device beforehand; then its checks. Returns (launch counts of
    the counted run, the kernel's measured numbers)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_stream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.recsys import fm as TFM

    arch = get_arch("fm")
    cfg = arch.cfg
    F, V = cfg.n_fields, cfg.vocab
    p99_b = arch.input_sizes("serve_p99")["ids"][0]
    bulk_b = arch.input_sizes("serve_bulk")["ids"][0]
    n_cand = arch.input_sizes("retrieval_cand")["candidate_ids"][0]
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = TFM.FM(cfg, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed))
    torch.cuda.synchronize()
    print(f"fm: {F} fields, k {cfg.embed_dim}, vocab {V}; "
          f"{sum(p.numel() for p in model.parameters())} float32 parameters "
          f"from seed {seed} in {time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()

    def batches(batch, n, start):
        stream = recsys_stream(batch, F, V, start_step=start, seed=seed)
        return [torch.from_numpy(next(stream)["ids"]).to(dev)
                for _ in range(n)]

    p99 = batches(p99_b, P99_WARMUP + P99_BATCHES, 0)
    bulk = batches(bulk_b, BULK_BATCHES, 1 << 20)
    rng = np.random.default_rng(seed)
    # ids that clip: negative, the int32 extremes, vocab and beyond
    edge = np.array([-1, -(1 << 31), V, (1 << 31) - 1, 0, V - 1], np.int64)
    ctx = rng.integers(0, V, F)
    ctx[:2] = edge[:2]
    cand = rng.integers(0, V, n_cand)
    cand[:len(edge)] = edge
    clip = rng.integers(-V, 2 * V, (p99_b, F))
    clip[:, :len(edge)] = edge
    ctx, cand, clip = (torch.from_numpy(a.astype(np.int32)).to(dev)
                       for a in (ctx, cand, clip))
    sizes = rng.integers(1, 9, bulk_b)
    sizes[rng.random(bulk_b) < 0.05] = 0
    bag_ids = torch.from_numpy(np.repeat(np.arange(bulk_b), sizes).astype(
        np.int32)).to(dev)
    bag_tok = torch.from_numpy(rng.integers(0, V, bag_ids.shape[0]).astype(
        np.int32)).to(dev)
    torch.cuda.synchronize()
    print(f"traffic: {P99_WARMUP} + {P99_BATCHES} batches of {p99_b}, "
          f"{BULK_BATCHES} of {bulk_b}, {n_cand} candidates, "
          f"{bag_ids.shape[0]} ids in {bulk_b} bags ({int((sizes == 0).sum())}"
          f" empty), made in {time.perf_counter() - t0:.3f} s", flush=True)

    measured = run_fm_kernel_checks(torch, seed, dev,
                                    TFM.take_clip(model.v, bulk[0]))
    torch.cuda.empty_cache()

    serve = arch.step_fn("serve_p99")
    retrieve = arch.step_fn("retrieval_cand")
    rbatch = {"context_ids": ctx, "candidate_ids": cand}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    def samples(fn, inputs, skip):
        """Host seconds of fn(x) for each x, each ending in a synchronize;
        the first ``skip`` are warm-up and not kept."""
        out = []
        for i, x in enumerate(inputs):
            t = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            if i >= skip:
                out.append(time.perf_counter() - t)
        return np.array(out) * 1e3

    p99_ms = samples(lambda ids: serve(model, {"ids": ids}), p99, P99_WARMUP)
    # one warm-up batch first (the allocator grows to the bulk size)
    bulk_ms = samples(lambda ids: serve(model, {"ids": ids}),
                      bulk[:1] + bulk, 1)
    # warm-up calls first (cuBLAS initializes on the first matvec)
    retrieval_ms = samples(lambda _: retrieve(model, rbatch),
                           range(3 + RETRIEVAL_CALLS), 3)
    bulk_out = serve(model, {"ids": bulk[0]})
    scores = retrieve(model, rbatch)
    clip_out = serve(model, {"ids": clip})
    bags = {mode: TFM.embedding_bag(model.v, bag_tok, bag_ids, bulk_b, mode)
            for mode in ("sum", "mean")}
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    def pct(a, q):
        return float(np.percentile(a, q, method="nearest"))

    print(f"recsys: serve_p99 latency p50 {pct(p99_ms, 50)} ms, p99 "
          f"{pct(p99_ms, 99)} ms over {len(p99_ms)} batches of {p99_b}; "
          f"serve_bulk {float(bulk_ms.mean())} ms per batch of {bulk_b} "
          f"({bulk_b / float(bulk_ms.mean()) * 1e3} examples/s; p50 "
          f"{pct(bulk_ms, 50)}, min {float(bulk_ms.min())}, max "
          f"{float(bulk_ms.max())} ms over {len(bulk_ms)} batches); "
          f"retrieval_cand {float(retrieval_ms.mean())} ms per call (p50 "
          f"{pct(retrieval_ms, 50)}, max {float(retrieval_ms.max())} ms over "
          f"{len(retrieval_ms)} calls) over {n_cand} candidates; peak device "
          f"memory {peak} B; launches {counts}", flush=True)
    want = {"fm_interaction": P99_WARMUP + P99_BATCHES + BULK_BATCHES + 3,
            "segment_reduce": 3}
    if counts != {**dict.fromkeys(counts, 0), **want}:
        raise AssertionError(f"recsys: launches {counts}, expected {want}")

    v64 = model.v.double().cpu().numpy()
    w64 = model.w.double().cpu().numpy()[:, 0]
    b64 = float(model.b)
    for label, ids, got in (("serve_p99 last batch", p99[-1], None),
                            ("serve_bulk first batch", bulk[0], bulk_out),
                            ("clipping batch", clip, clip_out)):
        if got is None:
            got = serve(model, {"ids": ids})
        want_l, scale = fm_reference(np, v64, w64, b64, ids.cpu().numpy())
        hold(np, f"recsys {label} vs float64 numpy", got.cpu().numpy(),
             want_l, scale)
    want_s, scale = retrieval_reference(np, v64, w64, b64, ctx.cpu().numpy(),
                                        cand.cpu().numpy())
    hold(np, "recsys retrieval_cand vs float64 numpy", scores.cpu().numpy(),
         want_s, scale)
    del v64, w64

    # the bags against the plain version (the same function on the CPU):
    # at most 8 float32 additions in another order, so 1e-6 of the bag's
    # sum (or mean) of |rows|; empty bags exactly 0
    table, tok, ids_b = model.v.cpu(), bag_tok.cpu(), bag_ids.cpu()
    empty = torch.from_numpy(sizes == 0)
    for mode, got in bags.items():
        got = got.cpu()
        want_b = TFM.embedding_bag(table, tok, ids_b, bulk_b, mode)
        mag = TFM.embedding_bag(table.abs(), tok, ids_b, bulk_b, mode)
        err = (got - want_b).abs()
        print(f"recsys embedding_bag {mode} [{bulk_b}, {cfg.embed_dim}]: max "
              f"abs err {float(err.max())}", flush=True)
        if not (bool((err <= 1e-6 * mag + 1e-12).all())
                and not bool(got[empty].any())):
            raise AssertionError(f"recsys embedding_bag {mode}: differs from "
                                 f"the plain version")
    if profile:
        profile_run(torch, "recsys serve_bulk", lambda: serve(
            model, {"ids": bulk[0]}))
        profile_run(torch, "recsys retrieval_cand", lambda: retrieve(
            model, rbatch))
    del model, p99, bulk, bags
    torch.cuda.empty_cache()
    return counts, measured


# -- phase train ------------------------------------------------------------

# bf16 gradients against the float32 plain version on the same inputs:
# |got - want| <= rtol |want| + atol_share * max |want| per output. The
# kernel's products are exact to about 2^-16 (P and dS split hi + lo) and
# its outputs round once to bf16 (2^-9 of a value), as the plain
# version's cast does; sums in another order move a value that cancels
# to near 0 by float32 units of the terms, well under the scale share.
BWD_RTOL, BWD_ATOL_SHARE = 1e-2, 1e-3
# float32 gradients against the plain version in float64 on the same
# float32 inputs: every product of the kernels is 3xTF32 (about 22
# significant bits of each term) and every long sum goes through fresh
# fragments added in f32; the emulation of their arithmetic
# (tests/test_torch_tf32_bwd_split.py, scores spanning +-60 in log2
# units, d 64 to 256, GQA 16:1, s 300) stays within 0.26 of this
# tolerance, attention_bwd_ref itself in float32 within 0.82 of it.
BWD_TOL = {"bfloat16": (BWD_RTOL, BWD_ATOL_SHARE),
           "float32": (1e-4, 1e-5)}
# the forward's lse, natural-log units (O(1 to 10)): bf16 inputs against
# the float32 plain version, float32 inputs against float64
LSE_ATOL = {"bfloat16": 1e-4, "float32": 2e-5}
TRAIN_TIMED_STEPS = 6
FM_TIMED_STEPS = 20
TRAIN_DIR = ROOT / "build" / "train"     # the resume check's checkpoints
# the adversarial shapes of the attention backward, run in bfloat16 and
# in float32: (b, hq, hkv, s, d, causal): head dims 64, 128 and 256, GQA
# 1:1, 2:1, 8:1 and 16:1, causal and not, s of 77 (a ragged tile), 128,
# 129, 300 and 4096
BWD_SHAPES = [(1, 16, 8, 4096, 128, True), (2, 16, 16, 128, 128, False),
              (1, 32, 2, 77, 128, True), (2, 8, 8, 77, 64, False),
              (1, 16, 8, 4096, 64, True), (1, 16, 1, 128, 64, True),
              (1, 4, 2, 4096, 128, False), (2, 8, 4, 77, 256, False),
              (1, 16, 2, 300, 256, True), (1, 4, 4, 129, 256, True)]


def dtype_name(t) -> str:
    """"float32" or "bfloat16": the key of a tensor's tolerances."""
    return str(t.dtype).split(".")[-1]


def attention_bwd_bound(q, causal):
    """(flops, their ms at the tensor peak of q's type) of the attention
    backward: five products of 2 d flops per visible (query, key) pair (s
    (s + 1) / 2 of them a head under causal, s^2 otherwise), at the bf16
    peak for bfloat16, TF32_PASSES times over at the TF32 peak for
    float32 (3xTF32)."""
    b, hq, s, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 5 * 2 * d * pairs * b * hq
    if dtype_name(q) == "float32":
        return flops, TF32_PASSES * flops / TF32_FLOPS_PER_S * 1e3
    return flops, flops / BF16_FLOPS_PER_S * 1e3


def bwd_products(q) -> dict:
    """The products the dK/dV and dQ kernels issue, in units of one of
    the bound's five: bf16 six and four (P and dS as hi + lo parts);
    float32 four and three (3xTF32 each, counted in the bound), six and
    three at d = 256 (S^T and dP^T computed by both warps of a pair)."""
    if dtype_name(q) == "float32":
        return {"dkdv": 6 if q.shape[-1] == 256 else 4, "dq": 3}
    return {"dkdv": 6, "dq": 4}


def bwd_bytes(q, k, lse):
    """Bytes the backward must move: q, k, v, o, dO and lse read once,
    dq, dk and dv written once."""
    es = q.element_size()
    return (4 * q.numel() + 4 * k.numel()) * es + lse.numel() * 4


def sdpa_backward(torch, q, k, v, do, causal):
    """The library yardstick: autograd of one scaled_dot_product_attention
    call on the same inputs (never called by the port); returns a function
    that runs its backward."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qq, kk, vv, is_causal=causal, enable_gqa=True)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                       retain_graph=True)


def sdpa_backward_backends(torch, q, k, v, do, causal) -> dict:
    """CUDA-event times of SDPA's backward on these inputs as PyTorch
    picks its backend, and with each of the flash, memory-efficient and
    cuDNN backends forced (None where one refuses the inputs); the
    forced time nearest the unforced one names the backend it picked.
    Printed; measurement only, no path of the port calls SDPA."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    out = {"picked": cuda_ms(torch, sdpa_backward(torch, q, k, v, do,
                                                  causal))}
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        name = backend.name.lower()
        try:
            with sdpa_kernel([backend]):
                run = sdpa_backward(torch, q, k, v, do, causal)
        except RuntimeError:        # this backend does not take them
            out[name] = None
            continue
        out[name] = cuda_ms(torch, run)
    timed = [n for n in out if n != "picked" and out[n] is not None]
    out["backend"] = min(timed, key=lambda n: abs(out[n] - out["picked"]))
    print(f"SDPA backward at {list(q.shape)}: {out}", flush=True)
    return out


def hold_bwd(torch, label, got, want):
    """Each of dq, dk, dv within rtol of the value plus a share of the
    output's largest value, ``BWD_TOL`` of the kernel outputs' dtype
    (compared in float32 for bfloat16, in float64 for float32); returns
    the largest absolute error."""
    worst = 0.0
    rtol, share = BWD_TOL[dtype_name(got[0])]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if dtype_name(got[0]) == "float32":
            g, w = g.double(), w.double()
        else:
            g, w = g.float(), w.float()
        scale = float(w.abs().max())
        err = (g - w).abs()
        bad = int((err > rtol * w.abs() + share * scale).sum())
        if bad or not bool(torch.isfinite(g).all()):
            raise AssertionError(
                f"{label}: {name} has {bad} values outside rtol {rtol} "
                f"+ {share} of max |want| {scale} (max abs err "
                f"{float(err.max())})")
        worst = max(worst, float(err.max()))
        print(f"{label}: {name} max abs err {float(err.max())} of max |want| "
              f"{scale}", flush=True)
    return worst


def check_attention_bwd(torch, label, q, k, v, do, causal, o=None,
                        lse=None, timed=False):
    """The forward kernel's lse against attention_lse_ref (``LSE_ATOL``),
    and the backward kernels against attention_bwd_ref on the same inputs
    (``hold_bwd``): for bf16 inputs the plain version in float32, for
    float32 inputs in float64; the plain version taken a batch element at
    a time; a second launch must give the same bits. With ``timed``, CUDA
    event times of the three launches, of the dK/dV and dQ launches
    apart, of the plain version (in the inputs' type) and of SDPA's
    backward beside the bound, and of the forward with and without its
    lse."""
    from repro_torch.kernels import flash_attention as FA, ref
    if lse is None:     # else the captured forward's output and lse
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        o = FA._prefill(q, k, v, causal, lse)
    kind = dtype_name(q)

    def plain_in(*ts):      # the yardstick's inputs: float64 for float32
        return [t.double() if kind == "float32" else t for t in ts]

    lse_err = 0.0
    for i in range(q.shape[0]):
        _, want = ref.attention_lse_ref(
            *plain_in(q[i:i + 1], k[i:i + 1], v[i:i + 1]), causal)
        lse_err = max(lse_err, float((lse[i:i + 1] - want).abs().max()))
    if not lse_err <= LSE_ATOL[kind]:
        raise AssertionError(f"{label}: lse off attention_lse_ref by "
                             f"{lse_err} (limit {LSE_ATOL[kind]})")

    def kernel():
        return FA.flash_attention_bwd(q, k, v, o, do, lse, causal)

    got = kernel()
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: a second launch gave other bits")
    want = [torch.cat(parts) for parts in zip(*(
        ref.attention_bwd_ref(*plain_in(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        o[i:i + 1], do[i:i + 1]),
                              lse[i:i + 1], causal)
        for i in range(q.shape[0])))]
    err = hold_bwd(torch, label, got, want)
    del want, again
    print(f"{label}: lse max abs err {lse_err}; a repeat gave the same bits",
          flush=True)
    if not timed:
        return dict(max_abs_err=err)
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: ref.attention_bwd_ref(
        q, k, v, o, do, lse, causal), reps=2, warmup=1)
    library_ms = cuda_ms(torch, sdpa_backward(torch, q, k, v, do, causal))
    flops, t_ops = attention_bwd_bound(q, causal)
    t_bytes = bound_ms(bwd_bytes(q, k, lse))
    b_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"{label}: backward kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"SDPA backward {library_ms:.4f} ms, bound {b_ms:.4f} ms by "
          f"{bound_by} ({flops:.4g} flop; {100 * b_ms / ms:.1f}% of it)",
          flush=True)
    # the two main launches apart, each beside the bound of the products
    # it issues (the bound counts five; ``bwd_products``)
    outs = [torch.empty_like(t) for t in (q, k, v)]
    launches = FA.bwd_launches(q, k, v, o, do, lse, causal, *outs)
    next(iter(launches.values()))()         # the pre pass
    apart = {}
    stem = FA.bwd_stem(q.dtype, q.shape[-1])
    for (part, name) in (("dkdv", "dK/dV"), ("dq", "dQ")):
        products = bwd_products(q)[part]
        t = cuda_ms(torch, launches[f"{stem}_{part}"])
        own = products * t_ops / 5
        apart[f"{part}_ms"] = t
        print(f"{label}: {name} kernel {t:.4f} ms against its {products} "
              f"products' {own:.4f} ms ({100 * own / t:.1f}% of it)",
              flush=True)
    del outs, launches
    fwd = cuda_ms(torch, lambda: FA._prefill(q, k, v, causal, None))
    fwd_lse = cuda_ms(torch, lambda: FA._prefill(q, k, v, causal, lse))
    print(f"{label}: {FA.prefill_kernel(q.dtype)} forward {fwd:.4f} ms "
          f"without lse, {fwd_lse:.4f} ms with it", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=bound_by, library_ms=library_ms, forward_ms=fwd,
                forward_lse_ms=fwd_lse, **apart)


@contextlib.contextmanager
def attention_bwd_captured(FA, layers):
    """Keep clones of the backward's inputs of the first and last layer
    (the backward runs the last layer first): yields {layer: (q, k, v, o,
    do, lse)}. The calls still go to the kernels."""
    captured, calls = {}, [0]
    kernel = FA.flash_attention_bwd

    def bwd(q, k, v, o, do, lse, causal=True):
        layer = layers - 1 - calls[0] % layers
        calls[0] += 1
        if layer in (0, layers - 1) and layer not in captured:
            captured[layer] = tuple(t.clone() for t in (q, k, v, o, do, lse))
        return kernel(q, k, v, o, do, lse, causal)

    FA.flash_attention_bwd = bwd
    try:
        yield captured
    finally:
        FA.flash_attention_bwd = kernel


def train_bytes(cfg, seq, b) -> int:
    """The reckoned peak of a train step of ``b`` sequences: the state
    (a bf16 config: bf16 parameters and gradients, float32 mu and nu, 12
    bytes a parameter; a float32 config (``cfg.dtype``): all four float32,
    16 bytes) plus, a sequence, the cross-entropy's buffers (20 bytes a
    token and vocab entry: the float32 logits and, at the backward's peak,
    four more logits-sized float32 buffers; the first full-depth run
    peaked at 21.1 bytes an entry at 4 x 4096) and the checkpointed layer
    inputs (one a layer, in the config's dtype: 2 or 4 bytes), plus one
    layer's transients in its recompute and backward, each in the
    config's dtype and counted twice (the tensor and its gradient): a
    dense FFN's four [tokens, d_ff] hiddens; an MoE's [E g cap, d] buffer
    and output, its four [E g cap, f] hiddens and two [tokens k, d]
    gathered rows (granite-3b at 8 x 4096: 327,680 buffer rows of 1536,
    1.0 GB each in bf16)."""
    n = cfg.param_count() + (cfg.vocab_padded - cfg.vocab) * cfg.d_model
    t = b * seq
    es = 4 if cfg.dtype == "float32" else 2     # bytes an activation
    per_seq = seq * (20 * cfg.vocab_padded + es * cfg.d_model * cfg.n_layers)
    if cfg.moe:
        from repro_torch.models import moe as M
        g, _, cap = M.group_plan(t, cfg.moe_groups, cfg.moe)
        rows = cfg.moe.n_experts * g * cap
        layer = 2 * es * (2 * rows * cfg.d_model + 4 * rows * cfg.moe.d_ff
                          + 2 * t * cfg.moe.top_k * cfg.d_model)
    else:
        layer = 2 * es * 4 * t * cfg.d_ff
    return (16 if es == 4 else 12) * n + b * per_seq + layer


def train_batch_size(torch, cfg, seq) -> tuple:
    """The largest per-step batch of {8, 4, 2, 1} whose reckoned memory
    (``train_bytes``) fits in 90% of the card. Returns (batch, reckoned
    bytes, card bytes)."""
    total = torch.cuda.get_device_properties(0).total_memory
    for b in (8, 4, 2, 1):
        if train_bytes(cfg, seq, b) <= 0.9 * total:
            return b, train_bytes(cfg, seq, b), total
    raise AssertionError(f"{cfg.name}: not even one sequence of {seq} fits")


def train_depth(torch, cfg, seq) -> int:
    """The most layers of ``cfg`` whose train step of one sequence fits
    in 90% of the card by ``train_bytes`` (gemma-7b's 28 layers need
    about 102 GB of state alone)."""
    total = torch.cuda.get_device_properties(0).total_memory
    for layers in range(cfg.n_layers, 0, -1):
        cut = dataclasses.replace(cfg, n_layers=layers)
        if train_bytes(cut, seq, 1) <= 0.9 * total:
            return layers
    raise AssertionError(f"{cfg.name}: not even one layer fits")


def snapshot(tree):
    from repro_torch.training.optim import tree_map
    return tree_map(lambda t: t.detach().clone(), tree)


def hold_close(torch, label, got, want, share, what):
    """Every leaf within ``share`` of its largest |want| (float32)."""
    from repro_torch.training.optim import tree_leaves
    worst = 0.0
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not (err <= share * scale and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{label}: {what} leaf {i} off by {err} of "
                                 f"scale {scale} (limit {share} of it)")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"{label}: {what} within {worst:.3g} of each leaf's scale (limit "
          f"{share})", flush=True)


# check_train_step_plain's tolerances by the config's dtype: loss and ce
# (relative), gnorm (relative), gradient leaves and mu, nu (each of the
# leaf's scale), and the unit of a parameter's type (bits of precision)
STEP_TOL = {"bfloat16": dict(loss=2e-3, gnorm=1e-2, grad=2e-2, nu=4e-2,
                             bits=8),
            "float32": dict(loss=1e-5, gnorm=1e-4, grad=1e-3, nu=2e-3,
                            bits=24)}


def check_train_step_plain(torch, seed, device="cuda",
                           arch_name="qwen3-1.7b", seq=None,
                           dtype="bfloat16"):
    """One train_4k step of an LM at full width and 2 layers, B = 1 (of
    ``seq`` tokens, default 4096), its config in ``dtype``, through the
    kernels and through the plain versions (the same autograd Function on
    attention_lse_ref and attention_bwd_ref), from the same weights and
    batch, held to ``STEP_TOL`` of the dtype. bfloat16: loss and ce
    within 2e-3 relative, gnorm 1e-2, every gradient leaf and mu within
    2e-2 of the leaf's scale, nu 4e-2 (bf16 activations differ by a unit
    here and there between the two attention routes, and the differences
    add up through two layers). float32: loss and ce within 1e-5, gnorm
    1e-4, gradients and mu 1e-3 of scale, nu 2e-3 (nu is the square of
    the gradients: twice their relative error): every activation is
    float32 and the two routes differ only in the attention kernels,
    whose outputs are within ATTN_TOL's 2e-5 and gradients within
    BWD_TOL's 1e-4 relative of the exact ones, so the step's values
    differ by float32 units of these, added up through two layers and
    the sums over 4096 tokens. Either type: each parameter within 2 lr
    (an Adam step moves a parameter by at most lr, its sign set by the
    gradient's, which may differ where that is near 0) plus one unit of
    the type. An MoE model's plain step routes as the kernel step did
    (``moe_routing``: its forward and its recompute replay the recorded
    experts, the gates its own probabilities at them): bf16 rounding
    flips choices near ties, and one flip changes a token's output by a
    whole expert."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train
    from repro_torch.models import moe as M
    from repro_torch.training.optim import (
        schedule, train_state_init, tree_leaves)
    arch = train.cut_layers(get_arch(arch_name), 2)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg,
                                                             dtype=dtype))
    tol = STEP_TOL[dtype]
    dev = torch.device(device)
    out, recorded = {}, None
    for route in ("kernels", "plain"):
        model = train.build_model(arch, False, dev, seed)
        state = train_state_init(model.param_tree())
        batch = next(train.make_batches(arch, "train_4k", False, dev, 1))
        if seq is not None:
            batch = {k: t[:, :seq].contiguous() for k, t in batch.items()}
        swap = (attention_swapped(FA, FA.attention_plain_autograd,
                                  FA.flash_decode)
                if route == "plain" else contextlib.nullcontext())
        routing = (contextlib.nullcontext() if not arch.cfg.moe
                   else moe_routing(torch, M, replay=recorded))
        with train.deterministic(dev), swap, routing as log:
            state, m = arch.step_fn("train_4k")(model, state, batch)
        if arch.cfg.moe and route == "kernels":
            recorded = log
        elif arch.cfg.moe:
            flips = [(call, len(tok), max(marg, default=0.0))
                     for call, tok, marg in log]
            print(f"{arch_name} 2 layers: the plain step replays the kernel "
                  f"step's routing in its {len(log)} MoE calls (forward "
                  f"and recompute); tokens whose own choice differs, and "
                  f"the largest of their margins, a call: {flips}",
                  flush=True)
        out[route] = (m, snapshot(model.grads),
                      snapshot(state.params), snapshot(state.mu),
                      snapshot(state.nu))
        del model, state
        torch.cuda.empty_cache()
    (mk, gk, pk, muk, nuk), (mp, gp, pp, mup, nup) = (out["kernels"],
                                                      out["plain"])
    label = (f"{arch_name} {dtype} train step, 2 layers, kernels against "
             f"plain")
    for k, rel in (("loss", tol["loss"]), ("ce", tol["loss"]),
                   ("gnorm", tol["gnorm"])):
        a, b = float(mk[k]), float(mp[k])
        print(f"{label}: {k} {a} against {b}", flush=True)
        if not (math.isfinite(a) and abs(a - b) <= rel * abs(b)):
            raise AssertionError(f"{label}: {k} {a} against {b}")
    hold_close(torch, label, gk, gp, tol["grad"], "gradient")
    hold_close(torch, label, muk, mup, tol["grad"], "mu")
    hold_close(torch, label, nuk, nup, tol["nu"], "nu")
    lr = float(schedule(arch.opt, torch.tensor(1.0)))
    ct = torch.float64 if dtype == "float32" else torch.float32
    for i, (a, b) in enumerate(zip(tree_leaves(pk), tree_leaves(pp))):
        a, b = a.to(ct), b.to(ct)
        unit = torch.exp2(torch.floor(torch.log2(
            b.abs().clamp_min(1e-30))) - (tol["bits"] - 1))
        if not bool(((a - b).abs() <= 2 * lr + unit).all()):
            raise AssertionError(f"{label}: parameter leaf {i} off by more "
                                 f"than 2 lr + one {dtype} unit")
    print(f"{label}: every parameter within 2 lr ({2 * lr:.3g}) plus one "
          f"{dtype} unit", flush=True)


def check_resume(torch, arch_name, extra, label):
    """launch/train.py: 6 steps with a checkpoint every 3, uninterrupted,
    and killed after step 4 (a crash at its train.step fault site) then
    resumed with --resume: the two final checkpoints must be byte-equal.
    Returns the seconds of the three runs."""
    import shutil
    import threading
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.engine.faults import (
        FaultPlan, FaultSpec, SimulatedCrash, install)
    from repro_torch.launch import train
    root = TRAIN_DIR / arch_name
    shutil.rmtree(root, ignore_errors=True)
    common = ["--arch", arch_name, "--steps", "6", "--ckpt-every", "3",
              "--log-every", "100"] + extra
    t0 = time.perf_counter()
    whole = train.main(common + ["--ckpt-dir", str(root / "whole")])
    plan = FaultPlan([FaultSpec("train.step", hit=5)])
    try:
        with install(plan):
            train.main(common + ["--ckpt-dir", str(root / "crashed")])
        raise AssertionError(f"{label}: the planned crash did not fire")
    except SimulatedCrash:
        pass
    for t in threading.enumerate():     # the crashed run's writer
        if t.name == CK.WRITER_THREAD:
            t.join()
    resumed = train.main(common + ["--ckpt-dir", str(root / "crashed"),
                                   "--resume"])
    seconds = time.perf_counter() - t0
    ma, a = CK.load_checkpoint(root / "whole", 6)
    mb, b = CK.load_checkpoint(root / "crashed", 6)
    same = ma == mb and set(a) == set(b) and all(
        a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()
        for key in a)
    print(f"{label}: crashed after step 4 ({plan.fired}), resumed "
          f"{resumed['steps']} steps; final state of {len(a)} leaves "
          f"byte-equal to the uninterrupted run's: {same}; last loss "
          f"{resumed['last_loss']} against {whole['last_loss']}; "
          f"{seconds:.3f} s for the three runs", flush=True)
    if not same or resumed["last_loss"] != whole["last_loss"]:
        raise AssertionError(f"{label}: the resumed state differs")
    shutil.rmtree(root, ignore_errors=True)


@contextlib.contextmanager
def moe_drops(M):
    """Record, for each MoE call, the share of its assignments that
    overflow their expert's capacity (a device scalar: no host read
    during the step). Yields the list."""
    routes, shares = M.routes, []

    def record(*args):
        r = routes(*args)
        shares.append(1.0 - r.keep.float().mean())
        return r

    M.routes = record
    try:
        yield shares
    finally:
        M.routes = routes


# a MoE train step's families (``scoped_family``, in this order): the
# kernels by name, then autograd's nodes of the dispatch and combine
# Functions, then the step's record_function scopes
MOE_STEP_FAMILIES = (
    ("attention (ours)", ("attn_wgmma",)),
    ("attention backward (ours)", ("bwd_dkdv", "bwd_dq", "bwd_pre",
                                   "bwd256")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
    ("MoE combine backward (_Combine)", ("_combinebackward",)),
    ("MoE dispatch backward (_Dispatch)", ("_dispatchbackward",)),
    ("MoE routing: softmax, top-k, sort, searchsorted",
     ("topk", "sort", "radix", "searchsorted")),
    ("gathers and scatters (index, gather, scatter)",
     ("index", "gather", "scatter")),
    ("zero the gradients", ("lm.zero_grads",)),
    ("global norm", ("lm.global_norm",)),
    ("AdamW", ("lm.adamw",)))


def train_lm(torch, seed, arch, dev, timed_steps, profile=False):
    """An LM trained on the card through launch/train.py's pieces and the
    arch's train_4k step: random weights in the config's dtype (bf16 or
    float32) from ``seed``, float32 moments, 4096 tokens a sequence at the
    largest batch that fits (``train_batch_size``), one warm-up step
    (capturing the attention backward's inputs of the first and last
    layer and, for an MoE, each layer's dropped share), then
    ``timed_steps`` counted, timed steps: step p50 and p99, tokens/s, peak
    memory against the reckoned, the model-FLOP share from
    ``model_flops`` (active parameters) at the bf16 tensor peak, or at
    the float32 peak outside the tensor cores for a float32 config (its
    GEMMs run with TF32 off). With
    ``profile`` one more step under torch.profiler (an MoE's by
    ``MOE_STEP_FAMILIES``) and the AdamW update alone by CUDA events.
    Returns {counts, captured, batch, seq, labels, p50, adamw_ms}."""
    import numpy as np
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import moe as M
    from repro_torch.training.optim import adamw_update, train_state_init
    cfg = arch.cfg
    seq = arch.input_sizes("train_4k")["tokens"][1]
    peak_flops = F32_FLOPS_PER_S if cfg.dtype == "float32" else (
        BF16_FLOPS_PER_S)
    B, reckoned, total = train_batch_size(torch, cfg, seq)
    print(f"{cfg.name} training: per-step batch {B} x {seq} (train_4k is "
          f"256 x {seq}); reckoned {reckoned} B of the card's {total}",
          flush=True)
    out = {"batch": B, "seq": seq, "adamw_ms": None}
    with train.deterministic(dev):
        t0 = time.perf_counter()
        model = train.build_model(arch, False, dev, seed)
        state = train_state_init(model.param_tree())
        step = arch.step_fn("train_4k")
        batches = train.make_batches(arch, "train_4k", False, dev, B)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        moe = (f", {cfg.moe.n_experts} experts of {cfg.moe.d_ff} top-"
               f"{cfg.moe.top_k} in {cfg.moe_groups} groups" if cfg.moe
               else "")
        print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, remat "
              f"{cfg.remat}{moe}; {n_params} {cfg.dtype} parameters, "
              f"float32 moments, from seed {seed} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        drops = moe_drops(M) if cfg.moe else contextlib.nullcontext([])
        with attention_bwd_captured(FA, cfg.n_layers) as captured, \
                drops as shares:
            state, m = step(model, state, next(batches))
            warm = float(m["loss"])
        print(f"warm-up step: loss {warm}", flush=True)
        if cfg.moe:     # the forward's calls, one a layer
            layer = [round(float(x), 4) for x in shares[:cfg.n_layers]]
            print(f"{cfg.name}: dropped share of the assignments a layer "
                  f"(warm-up step, capacity factor "
                  f"{cfg.moe.capacity_factor}): {layer}", flush=True)
        del shares
        reset_launch_counts()
        times, tokens = [], B * seq
        for i in range(timed_steps):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(model, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            vals = {k: float(v) for k, v in m.items()}
            print(f"step {i + 1}: loss {vals['loss']} ce {vals['ce']} gnorm "
                  f"{vals['gnorm']} ({times[-1]:.4f} s)", flush=True)
            if not all(math.isfinite(x) for x in vals.values()):
                raise AssertionError(f"step {i + 1}: not finite: {vals}")
        out["counts"] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        p50 = float(np.median(times))
        p99 = float(np.percentile(times, 99))
        flops = arch.model_flops("train_4k", global_batch=B)
        print(f"{cfg.name} train_4k at {B} x {seq}: step p50 {p50} s, p99 "
              f"{p99} s over {len(times)} steps (min {min(times)}, max "
              f"{max(times)}); {tokens / p50} tokens/s; peak allocated "
              f"{peak} B ({100 * peak / total:.1f}% of the card; reckoned "
              f"{reckoned})", flush=True)
        print(f"{cfg.name} model-FLOP share: 6 N tokens = {flops:.4g} flop "
              f"(N = {cfg.active_param_count()} active of "
              f"{cfg.param_count()}) a step, "
              f"{100 * flops / p50 / peak_flops:.2f}% of "
              f"{peak_flops:.4g} flop/s ({cfg.dtype}"
              f"{', TF32 off' if cfg.dtype == 'float32' else ''})",
              flush=True)
        if peak > 0.9 * total:
            raise AssertionError(f"peak {peak} B over 90% of the card")
        launches = {k: v for k, v in out["counts"].items() if v}
        print(f"launches over the timed steps: {launches}", flush=True)
        if profile:
            name = f"{cfg.name} train step"
            if cfg.moe:
                profile_step(torch, name, model, state,
                             lambda: model.loss_fn(batch["tokens"],
                                                   batch["labels"])[0],
                             arch.opt, "lm", MOE_STEP_FAMILIES,
                             {"gemm": flops / BF16_FLOPS_PER_S * 1e3})
            else:
                profile_run(torch, name, lambda: step(model, state, batch))
            grads = model.grad_tree()
            out["adamw_ms"] = cuda_ms(
                torch, lambda: adamw_update(state, grads, arch.opt), reps=3,
                warmup=1)
        out.update(labels=batch["labels"], captured=captured, p50=p50)
        del model, state, batches, batch
        torch.cuda.empty_cache()
    return out


def hold_captured_bwd(torch, name, captured, causal=True):
    """The backward kernels against their plain version on a train step's
    captured inputs, layer 0 timed; returns its numbers, max_abs_err the
    worst over the layers."""
    result = None
    for layer in sorted(captured):
        q, k, v, o, do, lse = captured[layer]
        r = check_attention_bwd(
            torch, f"{name} attention backward, layer {layer} of a train "
            f"step {list(q.shape)} over {list(k.shape)}", q, k, v, do,
            causal, o=o, lse=lse, timed=layer == 0)
        if result is None:
            result = r
        else:
            result["max_abs_err"] = max(result["max_abs_err"],
                                        r["max_abs_err"])
    return result


def run_train_phase(torch, seed, profile=False, device="cuda"):
    """Training on the card through launch/train.py's pieces and the
    arch's train_4k / train_batch step functions: the attention backward
    on adversarial shapes, in bf16 and in float32; qwen3-1.7b at full
    width and depth, random bf16
    weights from ``seed``, float32 moments, train_4k's 4096 tokens a
    sequence at the largest batch that fits, one warm-up step (capturing
    the attention backward's inputs of layers 0 and 27), then the counted
    timed steps; the kernels held against their plain versions on the
    captured inputs; one 2-layer step through the kernels against the
    plain versions; crash and resume at 2 layers; the FM at train_batch
    (the backward kernel on a step's rows, the timed steps, crash and
    resume). Returns (launch counts of the timed runs, measured numbers
    of the backward kernels)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    from repro_torch.models.common import cross_entropy_loss
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for dtype in (torch.bfloat16, torch.float32):
        for b, hq, hkv, s, d, causal in BWD_SHAPES:
            q = torch.randn((b, hq, s, d), generator=gen,
                            device=dev).to(dtype)
            k, v = (torch.randn((b, hkv, s, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            do = torch.randn((b, hq, s, d), generator=gen,
                             device=dev).to(dtype)
            check_attention_bwd(torch, f"attention backward "
                                f"{str(dtype)[6:]} b={b} hq={hq} hkv={hkv} "
                                f"s={s} d={d} "
                                f"{'causal' if causal else 'not causal'}",
                                q, k, v, do, causal)
            del q, k, v, do
    torch.cuda.empty_cache()

    arch = get_arch("qwen3-1.7b")
    counts = {}
    measured = {}
    run = train_lm(torch, seed, arch, dev, TRAIN_TIMED_STEPS, profile)
    add_counts(counts, run["counts"])
    captured = run["captured"]
    if profile:     # the step's cross-entropy alone, its model freed
        B, seq, cfg = run["batch"], run["seq"], arch.cfg
        labels = run["labels"]
        logits = torch.randn((B, seq, cfg.vocab_padded), generator=gen,
                             device=dev).bfloat16().requires_grad_()

        def ce():
            cross_entropy_loss(logits, labels).backward()

        with train.deterministic(dev):
            ce_ms = cuda_ms(torch, ce, reps=3, warmup=1)
        print(f"  by CUDA events: cross-entropy forward and backward "
              f"{ce_ms:.3f} ms, AdamW update {run['adamw_ms']:.3f} ms",
              flush=True)
        del logits
        torch.cuda.empty_cache()
    measured["flash_attention_bwd"] = hold_captured_bwd(
        torch, "qwen3-1.7b", captured)
    del captured, run
    torch.cuda.empty_cache()
    check_train_step_plain(torch, seed, device)
    torch.cuda.empty_cache()
    on = ["--device", device]
    check_resume(torch, "qwen3-1.7b", ["--layers", "2", "--batch", "1"] + on,
                 "qwen3-1.7b resume (2 layers, 1 x 4096)")
    torch.cuda.empty_cache()
    fm_counts, measured["fm_interaction_bwd"] = run_fm_train(
        torch, seed, device, profile)
    add_counts(counts, fm_counts)
    check_resume(torch, "fm", on, "fm resume (train_batch)")
    return counts, measured


F32_TRAIN_TIMED_STEPS = 4
# the float32 train step's attention launches: these keys each launch,
# the bf16 kernels' keys never
F32_TRAIN_KERNELS = ("flash_attention_tf32", "flash_attention_bwd_tf32_pre",
                     "flash_attention_bwd_tf32_dkdv",
                     "flash_attention_bwd_tf32_dq")
BF16_ATTENTION_KERNELS = ("flash_attention_wgmma", "flash_attention_bwd_pre",
                          "flash_attention_bwd_dkdv", "flash_attention_bwd_dq",
                          "flash_attention_bwd256_dkdv",
                          "flash_attention_bwd256_dq")


def run_train_f32_phase(torch, seed, profile=False, device="cuda"):
    """qwen3-1.7b trained in float32 on the card at full width and depth
    (28 layers, d_model 2048, 16/8 heads of 128, vocab 151,936; its config
    with dtype float32, as ``run_serve_f32`` builds its model) through
    ``train_lm``: float32 weights from ``seed``, train_4k at the largest
    batch ``train_bytes`` fits, one warm-up step capturing the backward's
    inputs of layers 0 and 27, then ``F32_TRAIN_TIMED_STEPS`` timed
    steps, whose launches must include every key of ``F32_TRAIN_KERNELS``
    and none of ``BF16_ATTENTION_KERNELS``; the float32 backward
    (csrc/flash_attention_bwd_tf32.cu) held against its plain version in
    float64 on the captured inputs, layer 0 timed beside SDPA's float32
    backward; one 2-layer float32 step through the kernels against the
    plain step. With ``profile`` the step under torch.profiler. Returns
    (launch counts of the timed steps, the backward's numbers)."""
    from repro_torch.configs import get_arch
    dev = torch.device(device)
    arch = get_arch("qwen3-1.7b")
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, dtype="float32"))
    run = train_lm(torch, seed, arch, dev, F32_TRAIN_TIMED_STEPS, profile)
    counts = run["counts"]
    wrong = ([k for k in F32_TRAIN_KERNELS if not counts[k]]
             + [k for k in BF16_ATTENTION_KERNELS if counts[k]])
    if wrong:
        raise AssertionError(f"qwen3-1.7b float32 train steps: launches "
                             f"{counts}; wrong for {wrong}")
    measured = hold_captured_bwd(torch, "qwen3-1.7b float32",
                                 run["captured"])
    q, k, v, o, do, lse = run["captured"][0]
    measured["library_backends"] = sdpa_backward_backends(torch, q, k, v,
                                                          do, True)
    del run, q, k, v, o, do, lse
    torch.cuda.empty_cache()
    check_train_step_plain(torch, seed, device, dtype="float32")
    torch.cuda.empty_cache()
    return counts, measured


MOE_TRAINS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")
MOE_TIMED_STEPS = 4
GEMMA_TIMED_STEPS = 4


def run_moe_train_phase(torch, seed, profile=False, device="cuda"):
    """MoE training on the card: granite-moe-1b-a400m and
    granite-moe-3b-a800m at full width and depth (``train_lm``: 24 and 32
    layers, 32 and 40 experts, top-8, 32 routing groups, the load-balance
    loss in the step's loss), their attention backward held against its
    plain version on each step's captured inputs; one 2-layer
    granite-moe-1b-a400m step through the kernels against the plain one
    with the kernel step's routing replayed; crash and resume at 2
    layers. With ``profile`` the granite-3b step by MOE_STEP_FAMILIES.
    Returns (launch counts of the timed runs, the backward's numbers of
    each model)."""
    from repro_torch.configs import get_arch
    dev = torch.device(device)
    counts, measured = {}, {}
    for name in MOE_TRAINS:
        run = train_lm(torch, seed, get_arch(name), dev, MOE_TIMED_STEPS,
                       profile and name == MOE_TRAINS[-1])
        add_counts(counts, run["counts"])
        measured[name] = hold_captured_bwd(torch, name, run["captured"])
        del run
        torch.cuda.empty_cache()
    check_train_step_plain(torch, seed, device, MOE_TRAINS[0])
    torch.cuda.empty_cache()
    check_resume(torch, MOE_TRAINS[0], ["--layers", "2", "--batch", "1",
                                        "--device", device],
                 f"{MOE_TRAINS[0]} resume (2 layers, 1 x 4096)")
    torch.cuda.empty_cache()
    return counts, measured


def run_gemma_train_phase(torch, seed, profile=False, device="cuda"):
    """gemma-7b trained on the card at full width (d_model 3072, 16
    heads of 256, GeGLU of 24,576, vocab 256,000) and the most layers
    whose step of one 4096-token sequence fits (``train_depth``; its
    state alone at 28 layers is about 102 GB), through the wgmma forward
    and the d = 256 backward (csrc/flash_attention_bwd256.cu), held
    against its plain version on the step's captured inputs and timed
    beside SDPA's backward (with each backend forced, to name the one
    PyTorch picks). Returns (launch
    counts of the timed steps, the d = 256 backward's numbers)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train
    dev = torch.device(device)
    arch = get_arch("gemma-7b")
    seq = arch.input_sizes("train_4k")["tokens"][1]
    layers = train_depth(torch, arch.cfg, seq)
    print(f"gemma-7b: {layers} of its {arch.cfg.n_layers} layers fit one "
          f"step of 1 x {seq} in 90% of the card", flush=True)
    run = train_lm(torch, seed, train.cut_layers(arch, layers), dev,
                   GEMMA_TIMED_STEPS, profile)
    measured = hold_captured_bwd(torch, "gemma-7b", run["captured"])
    q, k, v, o, do, lse = run["captured"][0]
    measured["library_backends"] = sdpa_backward_backends(torch, q, k, v,
                                                          do, True)
    counts = run["counts"]
    del run, q, k, v, o, do, lse
    torch.cuda.empty_cache()
    return counts, measured


def fm_step_bounds(torch, model, ids) -> dict:
    """Byte bounds (ms at HBM_BYTES_PER_S) of the FM train step's
    families, each input read once and each output written once: the
    gathers read the ids and the gathered rows of v and w and write them;
    the two kernels as their kernel lines count them; the scatter reads
    the rows' gradients and the ids and adds into the table's distinct
    rows that the ids touch (read and write); zeroing writes the
    gradients, the norm reads them; AdamW reads parameters, gradients
    and both moments and writes parameters and moments; the BCE reads
    the gathered w rows for the linear term and writes the logits and
    their gradient."""
    B, F = ids.shape
    k = model.v.shape[1]
    params = sum(p.numel() for p in model.param_tree().values())
    touched = int(torch.unique(ids.clamp(0, model.v.shape[0] - 1)).numel())
    rows = B * F * (k + 1) * 4
    return {"gathers (index_select)": bound_ms(ids.numel() * 4 + 2 * rows),
            "fm_interaction (ours)": bound_ms(B * F * k * 4 + B * 4),
            "fm_interaction backward (ours)": bound_ms(2 * B * F * k * 4
                                                       + B * 4),
            "scatter into the table (IndexSelectBackward)": bound_ms(
                rows + ids.numel() * 4 + 2 * touched * (k + 1) * 4),
            "zero the gradients": bound_ms(params * 4),
            "global norm": bound_ms(params * 4),
            "AdamW": bound_ms(7 * params * 4),
            "BCE, linear term and bias": bound_ms(B * F * 4 + 3 * B * 4)}


def profile_step(torch, name, model, state, loss, opt, scope, families,
                 bounds):
    """One train step (``grad_tree``, ``loss()``, backward,
    ``adamw_update``) under the profiler, each call in a record_function
    scope named ``scope``.zero_grads / .loss / .backward / .adamw and the
    global norm inside AdamW in ``scope``.global_norm, by ``families``
    (``scoped_family``), each family beside its bound from ``bounds``
    (family -> ms, or a callable giving that dict)."""
    from torch.profiler import record_function
    from repro_torch.training import optim

    norm = optim.global_norm

    def scoped_norm(grads):
        with record_function(f"{scope}.global_norm"):
            return norm(grads)

    def step():
        with record_function(f"{scope}.zero_grads"):
            grads = model.grad_tree()
        with record_function(f"{scope}.loss"):
            value = loss()
        with record_function(f"{scope}.backward"):
            value.backward()
        with record_function(f"{scope}.adamw"):
            optim.adamw_update(state, grads, opt)

    optim.global_norm = scoped_norm
    try:
        got = profile_run(torch, name, step, families=families)
    finally:
        optim.global_norm = norm
    if got:
        bounds = bounds() if callable(bounds) else bounds
        print("  family: device ms against its bound (ms):")
        for fam, ms in sorted(got.items(), key=lambda x: -x[1]):
            b_ms = bounds.get(fam)
            print(f"    {fam}: {ms:.4f} ms, bound "
                  + (f"{b_ms:.4f} ms ({100 * b_ms / ms:.1f}%)" if b_ms
                     else "none of its own"), flush=True)
        print(f"    sum of the bounds {sum(bounds.values()):.4f} ms",
              flush=True)


def profile_fm_step(torch, model, state, batch, opt):
    """One FM train step (``RecsysArch.step_fn``'s train_step) under the
    profiler by FM_STEP_FAMILIES, each family beside its byte bound."""
    profile_step(torch, "fm train_batch step", model, state,
                 lambda: model.loss_fn(batch["ids"], batch["labels"]), opt,
                 "fm", FM_STEP_FAMILIES,
                 lambda: fm_step_bounds(torch, model, batch["ids"]))


def run_fm_train(torch, seed, device="cuda", profile=False):
    """The fm config at train_batch (65,536 x 39 ids from recsys_stream):
    the backward kernel against fm_interaction_bwd_ref on a step's
    gathered rows (the forward's tolerance, ``ref.fm_allowed_error``,
    scaled by |g|, per value) and twice for the same bits, timed, with
    the route its plan took (the bulk stream); then a warm-up step and
    FM_TIMED_STEPS counted, timed steps; with ``profile`` one more step
    under the profiler (``profile_fm_step``)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import fm_interaction as FI
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models.recsys import fm as TFM
    from repro_torch.training.optim import train_state_init
    arch = get_arch("fm")
    dev = torch.device(device)
    B = arch.input_sizes("train_batch")["ids"][0]
    with train.deterministic(dev):
        model = train.build_model(arch, False, dev, seed)
        state = train_state_init(model.param_tree())
        step = arch.step_fn("train_batch")
        batches = train.make_batches(arch, "train_batch", False, dev)
        batch = next(batches)
        rows = TFM.take_clip(model.v.detach(), batch["ids"])
        x = torch.ones((1, 1), device=dev).expand(*rows.shape[:2])
        g = torch.randn((B,), generator=torch.Generator(dev).manual_seed(
            seed), device=dev) / B
        plan = FI.backward_plan(x, rows)
        print(f"fm_interaction backward at the train shape: route "
              f"{plan.route} ({plan._asdict()})", flush=True)
        if plan.route != "bulk":
            raise AssertionError(f"the train shape took route {plan.route}")
        _, dv = FI.fm_interaction_bwd(x, rows, g, need_dx=False)
        _, again = FI.fm_interaction_bwd(x, rows, g, need_dx=False)
        _, want = ref.fm_interaction_bwd_ref(x, rows, g)
        torch.cuda.synchronize()
        s = rows.sum(1, keepdim=True)
        allowed = (1e-5 * (s.abs() + rows.abs()).sum(1, keepdim=True)
                   * g.abs()[:, None, None] + 1e-12)
        err = (dv - want).abs()
        label = f"fm_interaction backward per-row v {list(rows.shape)}"
        if not (bool((err <= allowed).all()) and torch.equal(dv, again)):
            raise AssertionError(f"{label}: max abs err {float(err.max())}")
        ms = cuda_ms(torch, lambda: FI.fm_interaction_bwd(
            x, rows, g, need_dx=False), reps=20, warmup=3)
        plain_ms = cuda_ms(torch, lambda: ref.fm_interaction_bwd_ref(
            x, rows, g), reps=5, warmup=1)
        b_ms = bound_ms(2 * rows.numel() * 4 + g.numel() * 4)
        print(f"{label}: max abs err {float(err.max())} (limit 1e-5 of the "
              f"row's |S| + |v| sums times |g|), a repeat the same bits; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
              f"ms by bytes ({100 * b_ms / ms:.1f}% of it)", flush=True)
        measured = dict(max_abs_err=float(err.max()), ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
                        library_ms=None)
        del rows, dv, again, want
        state, m = step(model, state, batch)
        print(f"fm train_batch warm-up step: loss {float(m['loss'])}",
              flush=True)
        reset_launch_counts()
        times = []
        for i in range(FM_TIMED_STEPS):
            batch = next(batches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(model, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            loss, gnorm = float(m["loss"]), float(m["gnorm"])
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                raise AssertionError(f"fm step {i + 1}: loss {loss}")
        counts = launch_counts()
        p50 = float(np.median(times))
        print(f"fm train_batch ({B} examples): step p50 {p50 * 1e3:.4f} ms "
              f"over {FM_TIMED_STEPS} steps (max {max(times) * 1e3:.4f}); "
              f"{B / p50} examples/s; last loss {loss}, gnorm {gnorm}",
              flush=True)
        if profile:
            profile_fm_step(torch, model, state, next(batches), arch.opt)
        del model, state, batches
        torch.cuda.empty_cache()
    return counts, measured


# -- phase gnn: the GNNs' training -------------------------------------------

# (arch, shape): each at full width and depth on the largest shape of
# GNN_SHAPES one card holds (PERF.md section 4)
GNN_RUNS = (("gatedgcn", "minibatch_lg"), ("gat-cora", "full_graph_sm"),
            ("dimenet", "molecule"), ("nequip", "molecule"))
GNN_WARMUP_STEPS, GNN_TIMED_STEPS = 3, 10
# the segment reduce's calls captured from a step (layer 0's first)
GNN_CAPTURED = {"gatedgcn": 2, "gat-cora": 2, "dimenet": 1, "nequip": 3}
SUM_SHARE = 1e-5        # kernel against plain float sums: of the output's scale
# the gatedgcn step's families (``scoped_family``, in this order): the
# kernels by name, then autograd's nodes and profile_step's scopes
GNN_STEP_FAMILIES = (
    ("segment_reduce (ours)", ("reduce_tiles", "fill_identity",
                               "combine_crossing")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
    ("segment_reduce backward (gather)", ("_segmentreducebackward",)),
    ("scatter of the gathers' gradients (IndexSelectBackward)",
     ("indexselectbackward",)),
    ("gathers (index_select)", ("indexselect",)),
    ("accumulate into .grad (AccumulateGrad)", ("accumulategrad",)),
    ("zero the gradients", ("gnn.zero_grads",)),
    ("global norm", ("gnn.global_norm",)),
    ("AdamW", ("gnn.adamw",)),
    ("cross-entropy", ("logsumexp", "aten::gather", "gatherbackward")))


@contextlib.contextmanager
def segment_captured(SR, limit):
    """The first ``limit`` calls of ``SR.segment_reduce`` (a step's layer-0
    aggregations) recorded as (values, ids, num_segments, op), values
    detached and copied."""
    calls = []
    fn = SR.segment_reduce

    def recording(values, seg_ids, num_segments, op="sum"):
        if len(calls) < limit:
            calls.append((values.detach().clone(), seg_ids, num_segments, op))
        return fn(values, seg_ids, num_segments, op)

    SR.segment_reduce = recording
    try:
        yield calls
    finally:
        SR.segment_reduce = fn


@contextlib.contextmanager
def segment_plain(SR):
    """The segment reduce's plain version on every route: forward, and the
    backward's tie counts (the yardstick of the kernel step)."""
    reduce = SR._reduce
    SR._reduce = lambda values, ids, n, op: SR.segment_reduce_plain(
        values, ids, n, op)
    try:
        yield
    finally:
        SR._reduce = reduce


def check_segment_gnn(torch, label, vals, ids, n, op):
    """The kernel against its plain version on a GNN step's input: max and
    min bit-equal, sums within SUM_SHARE of the output's scale; for max
    and min also the backward's tie counts (a segment sum of the tie
    mask, through the kernel) equal. Returns the max abs error."""
    from repro_torch.kernels import segment_reduce as SR
    out = SR.segment_reduce(vals, ids, n, op)
    want = SR.segment_reduce_plain(vals, ids, n, op)
    torch.cuda.synchronize()
    finite = torch.isfinite(want)
    err = float((out - want)[finite].abs().max()) if finite.any() else 0.0
    scale = float(want[finite].abs().max()) if finite.any() else 0.0
    ok = (err <= SUM_SHARE * scale if op == "sum"
          else torch.equal(out, want))
    ties = ""
    if op != "sum":
        keep = ((ids >= 0) & (ids < n))[:, None]
        tie = ((vals == want.index_select(0, ids.clamp(0, n - 1)))
               & keep).float()
        got_c = SR.segment_reduce(tie, ids, n, "sum")
        want_c = SR.segment_reduce_plain(tie, ids, n, "sum")
        ok = ok and torch.equal(got_c, want_c)
        ties = (f"; tie counts equal (up to {int(want_c.max())} rows tied "
                f"in a column)")
    print(f"{label}: {op} {list(vals.shape)} over {n} segments, max abs err "
          f"{err} of scale {scale}"
          + (f" (limit {SUM_SHARE} of it)" if op == "sum" else " (bit-equal)")
          + ties, flush=True)
    if not ok:
        raise AssertionError(f"{label}: the kernel differs from the plain "
                             f"version")
    return err


def time_segment_gnn(torch, label, vals, ids, n):
    """The GNN shape's sum timed: the kernel, the plain version and one
    scatter_reduce (sum) into a buffer with a spare row for dropped ids,
    beside the byte bound."""
    from repro_torch.kernels import segment_reduce as SR
    ms = cuda_ms(torch, lambda: SR.segment_reduce(vals, ids, n, "sum"))
    plain_ms = cuda_ms(torch, lambda: SR.segment_reduce_plain(
        vals, ids, n, "sum"), reps=2, warmup=1)
    idx = ids.long().clamp(0, n)[:, None].expand_as(vals)
    base = torch.zeros((n + 1, vals.shape[1]), device=vals.device)
    library_ms = cuda_ms(torch, lambda: base.scatter_reduce(
        0, idx, vals, reduce="sum"))
    rows, d = vals.shape
    nbytes = rows * 4 + rows * d * 4 + n * d * 4
    print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scatter_reduce {library_ms:.4f} ms, byte bound "
          f"{bound_ms(nbytes):.4f} ms ({nbytes} B, "
          f"{100 * bound_ms(nbytes) / ms:.1f}% of it)", flush=True)
    return dict(shape=[rows, d, n], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms(nbytes), bound_by="bytes",
                library_ms=library_ms)


def gnn_step_bounds(torch, model, batch) -> dict:
    """Bounds (ms) of the gatedgcn step's families: the segment reduce
    (two sums a layer of [E, d] into [N, d], ids read once each), the
    gathers (two a layer, [E, d] written and the rows read, forward) by
    bytes; the GEMMs by float32 operations (the five d x d products a
    layer over 4 E + N rows, the input embedding and the head, forward
    and two backward products each); zeroing, the norm and AdamW by
    bytes of the parameters (AdamW reads parameters, gradients and two
    moments and writes three)."""
    cfg = model.cfg
    E, N = batch["senders"].shape[0], batch["node_feat"].shape[0]
    d, L, F = cfg.d_hidden, cfg.n_layers, cfg.d_in
    params = sum(p.numel() for p in model.parameters())
    flops = 3 * 2 * (L * d * d * (4 * E + N) + N * F * d + N * d
                     * cfg.n_classes + E * d)
    return {"segment_reduce (ours)": bound_ms(L * 2 * (E * 4 + E * d * 4
                                                       + N * d * 4)),
            "gemm": flops / F32_FLOPS_PER_S * 1e3,
            "gathers (index_select)": bound_ms(L * 2 * (E * 4 + 2 * E * d
                                                        * 4)),
            "zero the gradients": bound_ms(params * 4),
            "global norm": bound_ms(params * 4),
            "AdamW": bound_ms(7 * params * 4)}


def check_gnn_step_plain(torch, seed, dev, batch):
    """One gatedgcn step at full width and 2 layers on minibatch_lg's
    graph (``batch``) through the kernel and through the plain versions,
    from the same weights: loss within 1e-6 relative, every gradient leaf
    within 1e-4 of its scale."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import segment_reduce as SR
    from repro_torch.launch import train
    from repro_torch.training.optim import train_state_init
    arch = train.cut_layers(get_arch("gatedgcn"), 2)
    out = {}
    for route in ("kernels", "plain"):
        model = train.build_model(arch, False, dev, seed, "minibatch_lg")
        state = train_state_init(model.param_tree())
        swap = (segment_plain(SR) if route == "plain"
                else contextlib.nullcontext())
        with train.deterministic(dev), swap:
            state, m = arch.step_fn("minibatch_lg")(model, state, batch)
        out[route] = (float(m["loss"]), snapshot(model.grads))
        del model, state
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    label = "gatedgcn step, 2 layers, kernel against plain"
    print(f"{label}: loss {lk} against {lp}", flush=True)
    if not (math.isfinite(lk) and abs(lk - lp) <= 1e-6 * abs(lp)):
        raise AssertionError(f"{label}: loss {lk} against {lp}")
    hold_close(torch, label, gk, gp, 1e-4, "gradient")


def run_gnn(torch, seed, name, shape, dev, profile=False):
    """One GNN config at full width and depth on ``shape``'s graph (the
    reference launcher's, via launch/train.py): a warm-up of
    GNN_WARMUP_STEPS steps (the first capturing the segment reduce's
    first calls), GNN_TIMED_STEPS counted, timed steps, one forward and
    one backward counted apart, then the kernel held against its plain
    version on the captured inputs. Returns (launch counts of the timed
    steps, the captured calls, the batch)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels import segment_reduce as SR
    from repro_torch.launch import train
    from repro_torch.training.optim import train_state_init
    arch = get_arch(name)
    cfg = arch.config(shape)
    t0 = time.perf_counter()
    batch = next(train.make_batches(arch, shape, False, dev))
    E = batch["senders"].shape[0]
    N = batch["node_feat" if arch.kind == "feature" else "positions"].shape[0]
    extra = (f", {batch['t_kj'].shape[0]} triplets "
             f"({int((batch['t_ji'] < E).sum())} real)"
             if "t_kj" in batch else "")
    with train.deterministic(dev):
        model = train.build_model(arch, False, dev, seed, shape)
        state = train_state_init(model.param_tree())
        step = arch.step_fn(shape)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        print(f"{name} at {shape}: {cfg}; {N} nodes, {E} edges{extra}; "
              f"{n_params} float32 parameters from seed {seed}; graph and "
              f"model in {time.perf_counter() - t0:.3f} s", flush=True)
        torch.cuda.reset_peak_memory_stats()
        with segment_captured(SR, GNN_CAPTURED[name]) as captured:
            state, m = step(model, state, batch)
        warm = [float(m["loss"])]
        for _ in range(GNN_WARMUP_STEPS - 1):
            state, m = step(model, state, batch)
            warm.append(float(m["loss"]))
        reset_launch_counts()
        times, losses = [], []
        for i in range(GNN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(model, state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in warm + losses):
            raise AssertionError(f"{name}: losses not finite: {warm + losses}")
        # one forward and one backward apart: the kernel's launches in each
        reset_launch_counts()
        model.grad_tree()
        value = arch.loss_fn(shape)(model, batch)
        fwd = launch_counts()["segment_reduce"]
        value.backward()
        bwd = launch_counts()["segment_reduce"] - fwd
        p50 = float(np.median(times))
        p99 = float(np.percentile(times, 99))
        flops = arch.model_flops(shape)
        per_step = counts["segment_reduce"] / GNN_TIMED_STEPS
        print(f"{name} {shape}: step p50 {p50 * 1e3:.4f} ms, p99 "
              f"{p99 * 1e3:.4f} ms over {GNN_TIMED_STEPS} steps (after "
              f"{GNN_WARMUP_STEPS} warm-up); {E / p50:.6g} edges/s; peak "
              f"allocated {peak} B; losses {warm[0]} (first warm-up) to "
              f"{losses[-1]}, all finite; segment_reduce {per_step:g} "
              f"launches a step ({fwd} in a forward, {bwd} in a backward)",
              flush=True)
        print(f"{name} {shape}: model-FLOP share {flops:.4g} flop a step "
              f"(model_flops), {100 * flops / p50 / F32_FLOPS_PER_S:.3f}% of "
              f"{F32_FLOPS_PER_S:.4g} flop/s (float32, TF32 off)", flush=True)
        if profile and name == "gatedgcn":
            profile_step(torch, "gatedgcn minibatch_lg step", model, state,
                         lambda: arch.loss_fn(shape)(model, batch), arch.opt,
                         "gnn", GNN_STEP_FAMILIES,
                         lambda: gnn_step_bounds(torch, model, batch))
        del model, state, value
    torch.cuda.empty_cache()
    return counts, captured, batch


def run_gnn_phase(torch, seed, profile=False, device="cuda"):
    """The four GNN configs trained on the card (GNN_RUNS); the segment
    reduce held against its plain version on the captured inputs of
    gatedgcn's and dimenet's layer 0 (sums) and GAT's scores (max) and
    attention weights (sum), timed at gatedgcn's shape; a 2-layer
    gatedgcn step through the kernel against the plain one; crash and
    resume of gatedgcn at 2 layers, byte-equal. Returns (launch counts of
    the timed steps, the measured gnn shape)."""
    from repro_torch.kernels import segment_reduce as SR
    dev = torch.device(device)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("gnn: TF32 matmuls are allowed; the GNN "
                             "losses are held in float32")
    lib = SR._fn()
    for d in (8, 32, 56, 64, 70, 96, 128, 160):
        if lib.segment_reduce_smem(d) > SR.SMEM_LIMIT:
            raise AssertionError(f"segment_reduce at d = {d} needs "
                                 f"{lib.segment_reduce_smem(d)} B")
    counts, measured, kept = {}, None, None
    worst = 0.0
    for name, shape in GNN_RUNS:
        c, captured, batch = run_gnn(torch, seed, name, shape, dev, profile)
        add_counts(counts, c)
        for i, (vals, ids, n, op) in enumerate(captured):
            worst = max(worst, check_segment_gnn(
                torch, f"{name} segment_reduce call {i} of a step", vals,
                ids, n, op))
        if name == "gatedgcn":
            vals, ids, n, _ = captured[0]
            measured = time_segment_gnn(
                torch, "segment_reduce sum, gatedgcn layer 0's messages",
                vals, ids, n)
            kept = batch
        del captured, batch
        torch.cuda.empty_cache()
    measured["max_abs_err"] = worst
    check_gnn_step_plain(torch, seed, dev, kept)
    del kept
    torch.cuda.empty_cache()
    check_resume(torch, "gatedgcn", ["--layers", "2", "--shape",
                                     "minibatch_lg", "--device", device],
                 "gatedgcn resume (2 layers, minibatch_lg)")
    return counts, measured


# the MoE phase's models and greedy tokens; 8 requests of 2048 tokens
MOE_SERVES = (("granite-moe-3b-a800m", 64), ("granite-moe-1b-a400m", 16))

KERNELS = [
    ("merge_probe", "probe", "src/repro_torch/csrc/merge_probe.cu",
     "src/repro/kernels/merge_probe.py:53", None),
    ("merge_probe_multi", "probe_multi",
     "src/repro_torch/csrc/merge_probe.cu",
     "src/repro/kernels/merge_probe.py:220", None),
    ("segment_reduce", "segment_reduce",
     "src/repro_torch/csrc/segment_reduce.cu",
     "src/repro/kernels/segment_reduce.py:50",
     "src/repro/kernels/segment_reduce.py:79"),
    ("flash_attention_wgmma", "flash_attention_wgmma",
     "src/repro_torch/csrc/flash_attention_wgmma.cu",
     "src/repro/kernels/flash_attention.py:27", None),
    ("flash_attention", "flash_attention_tf32",
     "src/repro_torch/csrc/flash_attention_tf32.cu",
     "src/repro/kernels/flash_attention.py:27", None),
    ("flash_decode", "flash_decode",
     "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:122", None),
    ("fm_interaction", "fm_interaction",
     "src/repro_torch/csrc/fm_interaction.cu",
     "src/repro/kernels/fm_interaction.py:20", None),
    # the training path's backwards: no Pallas backward exists; each
    # replaces JAX's autograd of the reference's XLA forward
    ("flash_attention_bwd", "flash_attention_bwd_dkdv",
     "src/repro_torch/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/ref.py:124", None),
    ("flash_attention_bwd256", "flash_attention_bwd256_dkdv",
     "src/repro_torch/csrc/flash_attention_bwd256.cu",
     "src/repro/kernels/ref.py:124", None),
    ("flash_attention_bwd_tf32", "flash_attention_bwd_tf32_dkdv",
     "src/repro_torch/csrc/flash_attention_bwd_tf32.cu",
     "src/repro/kernels/ref.py:124", None),
    ("fm_interaction_bwd", "fm_interaction_bwd",
     "src/repro_torch/csrc/fm_interaction.cu",
     "src/repro/models/recsys/fm.py:69", None),
]


# the kernels the engine's device-mode loop captures
ENGINE_KERNELS = ("probe", "probe_multi", "segment_reduce")
# the kernels the durable phase's program runs (pathlen's MIN monoid
# combines with the segment reduce)
DURABLE_KERNELS = ("probe", "segment_reduce")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22,
                    help="Graph500 scale (2**scale vertices)")
    ap.add_argument("--profile", action="store_true",
                    help="also profile Reach, CC, SSSP (host and device "
                         "mode), the serve path (bf16 prefill and decode, "
                         "f32 prefill, the granite-3b MoE prefill and "
                         "decode), a serve_bulk batch and the qwen3 (bf16 "
                         "and float32), fm and gatedgcn train steps on the "
                         "card")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    # float32 matmuls at full precision (PyTorch's default; the FM
    # retrieval matvec refuses TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build, launch_counts
    except ImportError as e:
        print(f"chip_smoke: the port's sources are not beside this "
              f"script ({e})", file=sys.stderr)
        return 1

    t_all = time.perf_counter()
    with phase("card"):
        kind = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"device {kind}; {torch.cuda.device_count()} visible")
        print(smi, flush=True)
    with phase("build"):
        built = _build.build_all()
        print(f"built {sorted(built)}; the others' libraries match their "
              f"sources", flush=True)
        for name in _build.sources():
            lines = [ln for ln in _build.report(name).splitlines()
                     if "registers" in ln or "spill" in ln
                     or "error" in ln.lower()]
            print(f"{name}.cu:\n  " + "\n  ".join(lines), flush=True)
    with phase("kernels"):
        measured = run_kernel_checks(torch, args.seed, torch.device("cuda"))
        torch.cuda.empty_cache()
    with phase("attention"):
        run_attention_checks(torch, args.seed, torch.device("cuda"))
        torch.cuda.empty_cache()
    totals, captured, durable, sharded = run_engine_phases(
        torch, args.seed, args.scale, args.profile)
    torch.cuda.empty_cache()
    with phase("serve"):
        counts, serve_measured = run_serve_phase(torch, args.seed,
                                                 profile=args.profile)
        measured.update(serve_measured)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        counts, f32_measured = run_serve_f32(torch, args.seed,
                                             args.profile)
        measured.update(f32_measured)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    with phase("moe"):
        for arch, gen_tokens in MOE_SERVES:
            counts, moe_measured = run_serve_phase(
                torch, args.seed, gen_tokens=gen_tokens, arch=arch,
                profile=args.profile and arch == MOE_SERVES[0][0])
            for name, numbers in moe_measured.items():
                measured[name][arch] = numbers
            add_counts(totals, counts)
    with phase("recsys"):
        counts, measured["fm_interaction"] = run_recsys_phase(
            torch, args.seed, profile=args.profile)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    with phase("train"):
        counts, train_measured = run_train_phase(torch, args.seed,
                                                 args.profile)
        measured.update(train_measured)
        add_counts(totals, counts)
    with phase("train_f32"):
        counts, measured["flash_attention_bwd_tf32"] = run_train_f32_phase(
            torch, args.seed, args.profile)
        add_counts(totals, counts)
    with phase("train_moe"):
        counts, moe_measured = run_moe_train_phase(torch, args.seed,
                                                   args.profile)
        for arch, numbers in moe_measured.items():
            measured["flash_attention_bwd"][arch] = numbers
        add_counts(totals, counts)
    with phase("train_gemma"):
        counts, measured["flash_attention_bwd256"] = run_gemma_train_phase(
            torch, args.seed, args.profile)
        add_counts(totals, counts)
    with phase("gnn"):
        gnn_counts, measured["segment_reduce_gnn"] = run_gnn_phase(
            torch, args.seed, args.profile)
        add_counts(totals, gnn_counts)
    with phase("launches"):
        print("kernels " + json.dumps(totals), flush=True)
        print("kernels captured in device mode " + json.dumps(captured),
              flush=True)
        print("kernels of the durable phase " + json.dumps(durable),
              flush=True)
        print("kernels of the sharded engines " + json.dumps(
            {k: sharded.get(k, 0) for k in ENGINE_KERNELS}), flush=True)
        missing = [k for k, v in totals.items() if v == 0]
        missing += [f"{k} (device mode)" for k in ENGINE_KERNELS
                    if not captured.get(k)]
        missing += [f"{k} (durable)" for k in DURABLE_KERNELS
                    if not durable.get(k)]
        missing += [f"{k} (sharded)" for k in ENGINE_KERNELS
                    if not sharded.get(k)]
        if missing or set(totals) != set(launch_counts()):
            raise AssertionError(f"kernels never launched on the main "
                                 f"path: {missing}")
    entries = []
    for name, count_key, source, replaces, also in KERNELS:
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": totals[count_key]}
        if count_key in ENGINE_KERNELS:
            e["captured_launches"] = captured[count_key]
            e["durable_launches"] = durable.get(count_key, 0)
            e["sharded_launches"] = sharded.get(count_key, 0)
        e.update(measured[name])
        if also:
            e["also_replaces"] = also
        if name == "flash_decode":
            e["combine_launches"] = totals["flash_decode_combine"]
        if name == "flash_attention_bwd":
            e["pre_launches"] = totals["flash_attention_bwd_pre"]
            e["dq_launches"] = totals["flash_attention_bwd_dq"]
        if name == "flash_attention_bwd256":   # its pre pass is counted above
            e["dq_launches"] = totals["flash_attention_bwd256_dq"]
        if name == "flash_attention_bwd_tf32":
            e["pre_launches"] = totals["flash_attention_bwd_tf32_pre"]
            e["dq_launches"] = totals["flash_attention_bwd_tf32_dq"]
        if "_bwd" in name:
            e["note"] = ("no TPU kernel: replaces JAX's autograd of the "
                         "reference's XLA forward at 'replaces'")
        if name == "segment_reduce":    # the embedding_bag shape, timed
            e["embedding_bag_shape"] = measured["segment_reduce_bag"]
            e["gnn_shape"] = measured["segment_reduce_gnn"]
            e["gnn_launches"] = gnn_counts["segment_reduce"]
        entries.append(e)
    print(f"total {time.perf_counter() - t_all:.3f} s")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
