"""End-to-end LM training on the port — the counterpart of
``examples/train_lm.py``: a decoder trained on synthetic token streams
with the production loop (step-seeded data, AdamW, async checkpoints).

    PYTHONPATH=src python -m repro_torch.launch.train_lm --device cpu \\
        [--steps 40] [--batch 8] [--seq 128] [--ckpt-dir DIR]
    PYTHONPATH=src python -m repro_torch.launch.train_lm --full --steps 40

The configs are the reference example's: ``SMALL`` (about 2M parameters,
float32, d = 32 per head) and ``--full`` (about 100M, bf16, d = 64).
``SMALL`` trains on the card through the 3xTF32 prefill kernel with its
log-sum-exp and the float32 backward at head dim 32 (its mma.sync
route); ``--full`` through the bf16 prefill kernel with its log-sum-exp
and the d = 64 backward. Weights are drawn from seed 0 on the device.

Runs on the card; ``--device cpu`` runs the plain torch path (the tests).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.models.transformer import TransformerConfig

SMALL = TransformerConfig(          # ~2M params: CPU-friendly demo
    name="demo-2m", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=2048, dtype="float32", remat=False)

FULL_100M = TransformerConfig(      # ~100M params
    name="demo-100m", n_layers=12, d_model=768, n_heads=12,
    n_kv_heads=4, d_ff=3072, vocab=32768, dtype="bfloat16")

LOG_EVERY = 10
CKPT_EVERY = 20


def train(cfg: TransformerConfig, steps: int, batch: int, seq: int,
          device, ckpt_dir=None, params=None, on_step=None) -> list:
    """``steps`` AdamW steps of ``cfg`` on the step-seeded token stream;
    ``params`` (the reference's tree as tensors, ``params_from_numpy``)
    replaces the seed-0 weights. ``on_step(i)`` is called after each
    step. Returns the per-step losses."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import lm_batch_stream
    from repro_torch.models import transformer as T
    from repro_torch.training.optim import (
        AdamWConfig, adamw_update, train_state_init,
    )

    if params is None:
        params = T.init_params(cfg, torch.Generator(device).manual_seed(0))
    model = T.Transformer(cfg, params, device, train=True)
    state = train_state_init(model.param_tree())
    opt = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=steps)

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    stream = lm_batch_stream(batch, seq, cfg.vocab)
    losses, t0 = [], time.time()
    for i in range(steps):
        b = next(stream)
        tokens = torch.from_numpy(b["tokens"]).to(device)
        labels = torch.from_numpy(b["labels"]).to(device)
        grads = model.grad_tree()
        loss, _ce = model.loss_fn(tokens, labels)
        loss.backward()
        state, _gnorm = adamw_update(state, grads, opt)
        losses.append(float(loss.detach()))
        if on_step is not None:
            on_step(i)
        if i % LOG_EVERY == 0:
            print(f"step {i:4d} loss {losses[-1]:.4f}", flush=True)
        if ckpt and (i + 1) % CKPT_EVERY == 0:
            ckpt.save_async(i + 1, state)
    if ckpt:
        ckpt.wait()
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} in "
          f"{time.time() - t0:.1f}s")
    return losses


def main(argv=None) -> list:
    from repro_torch.models.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = FULL_100M if args.full else SMALL
    device = resolve_device(args.device, "launch.train_lm")
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")
    losses = train(cfg, args.steps, args.batch, args.seq, device,
                   args.ckpt_dir)
    assert losses[-1] < losses[0]
    print("train_lm OK")
    return losses


if __name__ == "__main__":
    main()
