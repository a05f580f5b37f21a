"""Sorted-segment reduction (sum / min / max).

The wrapper of ``csrc/segment_reduce.cu`` (a row-parallel pass: an
identity fill, a tiled segmented scan, and a combine of the runs that
cross tiles), which replaces both TPU kernels of
``repro.kernels.segment_reduce`` (``_resident_kernel`` and
``_tiled_kernel``). On CPU tensors it runs the
plain torch version (``kernels/ref.py``); on CUDA tensors it launches
the kernel or raises.

Contract: ``values`` [n] or [n, d] int32/float32, ``seg_ids`` [n] int32
sorted ascending; ids outside [0, num_segments) are dropped; int32 sums
wrap; empty segments get 0, the int32 extremes or +-inf; float sums are
deterministic (the same bits on every run).
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
    sorted ``seg_ids``."""
    if values.device.type == "cpu" and seg_ids.device.type == "cpu":
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
