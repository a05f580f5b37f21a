"""Gradient compression for a data-parallel all-reduce, after
``repro.training.compress``: per-leaf int8 absmax quantisation (optional
stochastic rounding) and top-k sparsification with error feedback, on
trees of tensors (leaves in JAX's flatten order).

Off the card's training path (one card has no all-reduce to shrink); the
algebra is held to the reference's on the CPU. Stochastic rounding draws
its noise from an explicit ``torch.Generator``, one uniform draw a leaf
in flatten order; it cannot give ``jax.random``'s bits, so it is held to
the reference's bounds, not to its values.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.training.optim import tree_leaves, tree_map


class CompressionState(NamedTuple):
    residual: Any           # error-feedback memory (top-k) or None


def init_state(grads, scheme: str) -> CompressionState:
    if scheme == "topk":
        return CompressionState(tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads))
    return CompressionState(None)


def quantize_int8(x: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """Per-tensor absmax int8 -> (q int8, scale float32 0-d); stochastic
    rounding (floor of y + U[0, 1)) when ``generator`` is given, round
    half to even otherwise."""
    x32 = x.float()
    scale = torch.clamp_min(x32.abs().max(), 1e-12) / 127.0
    y = x32 / scale
    if generator is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=generator,
                                       dtype=torch.float32,
                                       device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def topk_sparsify(x: torch.Tensor, density: float):
    """Keep the k = density * n largest-|.| entries of the flattened x:
    (kept [x's shape] float32, (indices int64, values float32))."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * density))
    idx = torch.topk(flat.abs(), k).indices
    vals = flat[idx]
    kept = torch.zeros_like(flat).index_put_((idx,), vals)
    return kept.reshape(x.shape), (idx, vals)


def compress_grads(grads, state: CompressionState, scheme: str,
                   density: float = 0.01,
                   generator: Optional[torch.Generator] = None):
    """-> (wire_grads, new_state, wire_bytes_estimate); the reference's
    wire counts (int8: one byte a value and a float32 scale a leaf;
    top-k: 4-byte indices and values)."""
    if scheme == "none":
        size = sum(g.numel() * g.element_size() for g in tree_leaves(grads))
        return grads, state, size
    leaves = tree_leaves(grads)
    if scheme == "int8":
        out = []
        for g in leaves:
            q, s = quantize_int8(g, generator)
            out.append(dequantize_int8(q, s, g.dtype))
        wire = sum(g.numel() + 4 for g in leaves)
        return _unflatten(grads, out), state, wire
    if scheme == "topk":
        out, new_res, wire = [], [], 0
        for g, r in zip(leaves, tree_leaves(state.residual)):
            acc = g.float() + r
            kept, (idx, vals) = topk_sparsify(acc, density)
            new_res.append(acc - kept)           # error feedback
            out.append(kept.to(g.dtype))
            wire += idx.numel() * 4 + vals.numel() * 4
        return (_unflatten(grads, out),
                CompressionState(_unflatten(grads, new_res)), wire)
    raise ValueError(f"unknown compression scheme {scheme}")


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
