"""Shared neural building blocks, after ``repro.models.common``.

Explicit dtypes throughout. ``maybe_shard`` and ``active_abstract_mesh``
(mesh plumbing, no meaning on one device) are not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def resolve_device(spec, owner: str) -> torch.device:
    """``spec`` as a device; raises when it names CUDA and there is no
    card, so that an entry point never falls back to the CPU unasked."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(spec)!r}) but no CUDA device is "
            f"available; pass device='cpu' to run the plain torch path")
    return device


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """``t`` as a parameter that takes no gradient (serving)."""
    return torch.nn.Parameter(t, requires_grad=False)


def parameter(t: torch.Tensor, train: bool) -> torch.nn.Parameter:
    """``t`` as a parameter sharing its storage: trainable when ``train``
    (training), else ``frozen``."""
    return torch.nn.Parameter(t, requires_grad=True) if train else frozen(t)


def wire_grads(pairs) -> None:
    """For each (parameter, buffer) pair: zero the buffer and make it the
    parameter's ``.grad``, so that backward accumulates into it in place
    (autograd adds into a defined ``.grad``). A model whose per-layer
    parameters are views of stacked tensors gets its gradients in the
    stacked layout this way, without a copy."""
    for p, buf in pairs:
        buf.zero_()
        if p.grad is not buf:
            p.grad = buf


def normal_init(shape, stddev: float, dtype: torch.dtype,
                generator: torch.Generator, device=None) -> torch.Tensor:
    """Normal(0, stddev) in ``dtype``, scaled in that dtype, drawn from
    ``generator`` (on the generator's device unless ``device`` says)."""
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=device)
    return x * torch.tensor(stddev, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype, then times (1 + gamma) in
    that dtype (the reference's rounding order)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * (1.0 + gamma.to(dt))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with float32 statistics (mean, population variance,
    ``rsqrt(var + eps)``), cast back to x's dtype, then times gamma plus
    beta in that dtype (the reference's order)."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gamma.to(dt) + beta.to(dt)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                rot_dim: Optional[int] = None):
    """positions int [*S] -> (sin, cos) [*S, rot_dim / 2] float32.
    ``rot_dim`` < head_dim gives partial rotary (ChatGLM's 2d RoPE
    rotates half the head dimensions)."""
    rot = rot_dim or head_dim
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, rot, 2, dtype=torch.float32,
                       device=positions.device) / rot)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; sin/cos [..., S, rot / 2] broadcast over heads.
    Rotates interleaved pairs (0::2, 1::2) of the first
    ``2 * sin.shape[-1]`` dims and passes the rest."""
    rot = 2 * sin.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    s = sin[..., None, :].to(x.dtype)
    c = cos[..., None, :].to(x.dtype)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy: logits [*, V] of any float dtype, taken
    in float32 (float32 logsumexp); labels int, clipped into [0, V - 1]
    for the gather; positions labelled ``ignore_id`` are left out of the
    mean (0 when every position is)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    idx = labels.long().clamp(0, lg.shape[-1] - 1)
    ll = torch.gather(lg, -1, idx[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - ll) * mask) / torch.clamp_min(mask.sum(), 1.0)
