"""Factorization-machine 2-way interaction.

The wrapper of ``csrc/fm_interaction.cu``, which replaces the TPU kernel
``_fm_kernel`` of ``repro.kernels.fm_interaction``. On CPU tensors it
runs the plain torch version (``kernels/ref.py``); on CUDA tensors it
launches the kernel or raises.

Contract (``repro.kernels.ops.fm_interaction``, with its ``jax.vmap``
over rows written out as a batch dimension of ``v``):
- ``x`` [b, f] at any element strides (``torch.ones(1, 1).expand(b, f)``
  costs no memory);
- ``v`` [f, k], one factor matrix for every row, or [b, f, k], one per
  row at any batch stride (0 included); each [f, k] matrix contiguous;
- float32 or bfloat16, all alike; the kernel computes in float32 and
  returns [b] in x's dtype;
- any b >= 0, f >= 1, and 1 <= k <= MAX_K.
There is no backward: an input that requires grad is refused on the
card (training is not ported yet; ROADMAP.md).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"fm_interaction": 0}
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
    if x.requires_grad or v.requires_grad:
        raise RuntimeError("fm_interaction: the kernel has no backward; "
                           "inputs must not require grad")
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
    """[b] FM 2-way term of the rows of ``x`` under ``v``."""
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


def _fn():
    lib = _build.load("fm_interaction")
    f = lib.fm_interaction
    if f.argtypes is None:
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [P, I64, I64, P, I64, I, I64, I64, I, P, P]
        f.restype = I
    return lib
