"""Sorted-segment reduction (sum / min / max).

The wrapper of ``csrc/segment_reduce.cu`` (a row-parallel pass: an
identity fill, a tiled segmented scan, and a combine of the runs that
cross tiles), which replaces both TPU kernels of
``repro.kernels.segment_reduce`` (``_resident_kernel`` and
``_tiled_kernel``). On CPU tensors (and meta tensors, in a dry run) it
runs the plain torch version (``kernels/ref.py``); on CUDA tensors it
launches the kernel or raises.

Contract: ``values`` [n] or [n, d] int32/float32, ``seg_ids`` [n] int32
sorted ascending; ids outside [0, num_segments) are dropped; int32 sums
wrap; empty segments get 0, the int32 extremes or +-inf; float sums are
deterministic (the same bits on every run).

When ``values`` requires grad (and grad mode is on) the call goes
through a ``torch.autograd.Function`` (``_SegmentReduce``): its forward
is the same kernel (the plain version on the CPU), and one backward
serves both routes, with the gradient JAX gives ``jax.ops.segment_sum``,
``segment_max`` and ``segment_min`` (the scatter's rules): for sum, the
output gradient gathered at each row's id; for max and min, that
gradient split evenly among the rows equal to their segment's extreme,
column by column (a segment whose extreme is its identity, every value
+-inf, counts its initial value as one more tie, as JAX's does). Rows
with a dropped id get 0. The tie counts are a segment sum of the tie
mask, through the kernel on the card; the gathers are ``index_select``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

OPS = {"sum": 0, "min": 1, "max": 2}
LAUNCHES = {"segment_reduce": 0}
SMEM_LIMIT = 232448        # dynamic shared memory a block may opt into

segment_reduce_plain = ref.segment_reduce_ref


def _check(values: torch.Tensor, seg_ids: torch.Tensor, op: str) -> None:
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(
            f"segment_reduce: values on {values.device}, seg_ids on "
            f"{seg_ids.device}; the kernel takes one CUDA device")
    if values.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"segment_reduce: values dtype {values.dtype}; "
                        f"the kernel takes int32 or float32")
    if seg_ids.dtype != torch.int32:
        raise TypeError("segment_reduce: seg_ids must be int32")
    if values.dim() not in (1, 2) or seg_ids.dim() != 1 or (
            seg_ids.shape[0] != values.shape[0]):
        raise ValueError("segment_reduce: values [n] or [n, d] with "
                         "seg_ids [n]")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_reduce: inputs must be contiguous")
    if op not in OPS:
        raise ValueError(f"segment_reduce: op {op!r}")


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """[num_segments] (or [num_segments, d]) reduction of ``values`` over
    sorted ``seg_ids``; differentiable in ``values`` when it requires
    grad."""
    if torch.is_grad_enabled() and values.requires_grad:
        return _SegmentReduce.apply(values, seg_ids, num_segments, op)
    return _reduce(values, seg_ids, num_segments, op)


def _reduce(values: torch.Tensor, seg_ids: torch.Tensor,
            num_segments: int, op: str) -> torch.Tensor:
    if _build.runs_plain(values, seg_ids):
        return segment_reduce_plain(values, seg_ids, num_segments, op)
    _check(values, seg_ids, op)
    n = values.shape[0]
    d = 1 if values.dim() == 1 else values.shape[1]
    out = torch.empty((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    if num_segments and d:
        lib = _fn()
        if lib.segment_reduce_smem(d) > SMEM_LIMIT:
            raise ValueError(f"segment_reduce: {d} columns need "
                             f"{lib.segment_reduce_smem(d)} B of shared "
                             f"memory")
        # 2 partials per tile for the runs that cross a tile's edge
        scratch = torch.empty((lib.segment_reduce_scratch(n, d),),
                              dtype=values.dtype, device=values.device)
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            rc = lib.segment_reduce(
                values.data_ptr(), int(values.dtype == torch.float32),
                seg_ids.data_ptr(), n, d, num_segments, OPS[op],
                out.data_ptr(), scratch.data_ptr(), stream)
        _build.check(rc, "segment_reduce")
        _build.count_launch(LAUNCHES, "segment_reduce")
    return out


class _SegmentReduce(torch.autograd.Function):
    """The reduction, whose backward is JAX's gradient of the segment ops
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, values, seg_ids, num_segments, op):
        out = _reduce(values.contiguous(), seg_ids, num_segments, op)
        ctx.num_segments, ctx.op = num_segments, op
        if op == "sum":
            ctx.save_for_backward(seg_ids)
        else:
            ctx.save_for_backward(seg_ids, values, out)
        return out

    @staticmethod
    def backward(ctx, g):
        n, op = ctx.num_segments, ctx.op
        seg_ids = ctx.saved_tensors[0]
        rows = seg_ids.shape[0]
        shape = (rows,) + tuple(g.shape[1:])
        if n == 0:
            return g.new_zeros(shape), None, None, None
        keep = ((seg_ids >= 0) & (seg_ids < n)).reshape(
            (rows,) + (1,) * (g.dim() - 1))
        idx = seg_ids.clamp(0, n - 1)
        g_rows = g.contiguous().index_select(0, idx)
        if op == "sum":
            return torch.where(keep, g_rows, 0), None, None, None
        _, values, out = ctx.saved_tensors
        tie = (values == out.index_select(0, idx)) & keep
        count = _reduce(tie.to(values.dtype), seg_ids, n, "sum")
        count = count + (out == ref._identity(op, out.dtype)).to(count.dtype)
        share = torch.where(tie, 1.0 / count.index_select(0, idx), 0)
        return g_rows * share, None, None, None


def _fn():
    lib = _build.load("segment_reduce")
    f = lib.segment_reduce
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        for g in (lib.segment_reduce_scratch, lib.segment_reduce_smem):
            g.restype = ctypes.c_int64
        lib.segment_reduce_scratch.argtypes = [ctypes.c_int64,
                                               ctypes.c_int64]
        lib.segment_reduce_smem.argtypes = [ctypes.c_int64]
    return lib
