"""Factorization-machine 2-way interaction.

The wrapper of ``csrc/fm_interaction.cu``, which replaces the TPU kernel
``_fm_kernel`` of ``repro.kernels.fm_interaction``. On CPU tensors it
runs the plain torch version (``kernels/ref.py``); on CUDA tensors it
launches the kernel or raises.

When an input requires grad (and grad mode is on) the call goes through
a ``torch.autograd.Function``: its forward is the same kernel, its
backward the kernel's backward entry (launch key ``fm_interaction_bwd``;
``fm_interaction_bwd_ref`` on the CPU), which gives
dv_fk = g x_f (S_k - x_f v_fk) with S_k = sum_f x_f v_fk, and dx only when
x requires grad. A shared v [f, k] gets its per-row terms summed over
rows by the wrapper (in float32, rounded once to v's dtype).

Contract (``repro.kernels.ops.fm_interaction``, with its ``jax.vmap``
over rows written out as a batch dimension of ``v``):
- ``x`` [b, f] at any element strides (``torch.ones(1, 1).expand(b, f)``
  costs no memory);
- ``v`` [f, k], one factor matrix for every row, or [b, f, k], one per
  row at any batch stride (0 included); each [f, k] matrix contiguous;
- float32 or bfloat16, all alike; the kernel computes in float32 and
  returns [b] in x's dtype;
- any b >= 0, f >= 1, and 1 <= k <= MAX_K.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"fm_interaction": 0, "fm_interaction_bwd": 0}
MAX_K = 32      # the lanes of one row's factor columns lie in one warp

fm_interaction_plain = ref.fm_interaction_ref


def _check(x: torch.Tensor, v: torch.Tensor) -> int:
    """Validates the inputs for the kernel; returns v's batch stride."""
    if x.device.type != "cuda" or v.device != x.device:
        raise ValueError(f"fm_interaction: x on {x.device}, v on "
                         f"{v.device}; the kernel takes one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or v.dtype != x.dtype:
        raise TypeError(f"fm_interaction: dtypes {x.dtype}, {v.dtype}; the "
                        f"kernel takes float32 or bfloat16, all alike")
    if x.dim() != 2 or v.dim() not in (2, 3):
        raise ValueError(f"fm_interaction: x {tuple(x.shape)}, v "
                         f"{tuple(v.shape)}; x [b, f] with v [f, k] or "
                         f"[b, f, k]")
    b, f = x.shape
    k = v.shape[-1]
    if tuple(v.shape[:-1]) != ((f,) if v.dim() == 2 else (b, f)):
        raise ValueError(f"fm_interaction: x {tuple(x.shape)} does not "
                         f"match v {tuple(v.shape)}")
    if f < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"fm_interaction: f = {f}, k = {k}; the kernel "
                         f"takes f >= 1 and 1 <= k <= {MAX_K}")
    if (k > 1 and v.stride(-1) != 1) or (f > 1 and v.stride(-2) != k):
        raise ValueError(f"fm_interaction: v strides {v.stride()}; each "
                         f"[f, k] matrix must be contiguous")
    if min(x.stride()) < 0:
        raise ValueError(f"fm_interaction: x strides {x.stride()}")
    return 0 if v.dim() == 2 or b == 1 else v.stride(0)


def fm_interaction(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b] FM 2-way term of the rows of ``x`` under ``v``;
    differentiable (``_FMInteraction``) when an input requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or v.requires_grad):
        return _FMInteraction.apply(x, v)
    return _forward(x, v)


class _FMInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v):
        ctx.save_for_backward(x, v)
        return _forward(x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        dx, dv = fm_interaction_bwd(x, v, g.contiguous(),
                                    need_dx=ctx.needs_input_grad[0])
        return dx, dv


def _forward(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu" and v.device.type == "cpu":
        return fm_interaction_plain(x, v)
    sv_b = _check(x, v)
    b, f = x.shape
    out = torch.empty((b,), dtype=x.dtype, device=x.device)
    if b:
        lib = _fn()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.fm_interaction(
                x.data_ptr(), x.stride(0), x.stride(1), v.data_ptr(), sv_b,
                int(x.dtype == torch.bfloat16), b, f, v.shape[-1],
                out.data_ptr(), stream)
        _build.check(rc, "fm_interaction")
        _build.count_launch(LAUNCHES, "fm_interaction")
    return out


def fm_interaction_bwd(x: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       need_dx: bool = True):
    """(dx [b, f] or None, dv in v's shape) of ``fm_interaction`` under
    output gradient g [b] (x's dtype, contiguous): one launch of the
    kernel's backward entry; ``fm_interaction_bwd_ref`` on CPU
    tensors."""
    if all(t.device.type == "cpu" for t in (x, v, g)):
        dx, dv = ref.fm_interaction_bwd_ref(x, v, g)
        return (dx if need_dx else None), dv
    if v.dim() == 2 and v.dtype != torch.float32:
        # a shared v sums the rows' terms: take them in float32, round once
        dx, dv = fm_interaction_bwd(x.float(), v.float(), g.float(), need_dx)
        return (dx.to(x.dtype) if need_dx else None), dv.to(v.dtype)
    sv_b = _check(x, v)
    b, f = x.shape
    k = v.shape[-1]
    if (g.shape != (b,) or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"fm_interaction_bwd: g must be [{b}] {x.dtype} "
                         f"on {x.device}")
    dv = torch.empty((b, f, k), dtype=v.dtype, device=v.device)
    dx = torch.empty((b, f), dtype=x.dtype, device=x.device) if (
        need_dx) else None
    if b:
        lib = _fn()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.fm_interaction_bwd(
                x.data_ptr(), x.stride(0), x.stride(1), v.data_ptr(), sv_b,
                g.data_ptr(), int(x.dtype == torch.bfloat16), b, f, k,
                dv.data_ptr(), dx.data_ptr() if need_dx else None, stream)
        _build.check(rc, "fm_interaction_bwd")
        _build.count_launch(LAUNCHES, "fm_interaction_bwd")
    if v.dim() == 2:        # one matrix for every row: sum the rows' terms
        dv = dv.sum(dim=0)
    return dx, dv


def _fn():
    lib = _build.load("fm_interaction")
    f = lib.fm_interaction
    if f.argtypes is None:
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [P, I64, I64, P, I64, I, I64, I64, I, P, P]
        f.restype = I
        lib.fm_interaction_bwd.argtypes = [P, I64, I64, P, I64, P, I, I64,
                                           I64, I, P, P, P]
        lib.fm_interaction_bwd.restype = I
    return lib
