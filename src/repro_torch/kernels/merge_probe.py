"""Rank probe: lower and upper ranks of probe keys in sorted build keys.

The wrapper of ``csrc/merge_probe.cu`` (one template over the word count
W = 1..4), which replaces the TPU kernels ``_probe_kernel`` and
``_probe_multi_kernel`` of ``repro.kernels.merge_probe``. On CPU tensors
it runs the plain torch version (``kernels/ref.py``); on CUDA tensors it
launches the kernel or raises.

Contract: ``lo`` and ``hi`` are exactly ``searchsorted`` left and right
for every probe key, sorted or not, KEY_PAD included.

The kernel searches a sample of the build keys in shared memory first,
then a window of ``stride`` keys in device memory; ``sample_plan``
chooses the sample for the build's size and word count.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_WORDS = 4
SAMPLE_BYTES = 32768     # the shared-memory sample's ceiling per CTA
# launches of the CUDA kernel per wrapper (W = 1 / W >= 2)
LAUNCHES = {"probe": 0, "probe_multi": 0}


def merge_probe_plain(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """The plain torch version, for [m] / [n] or [m, W] / [n, W] keys."""
    if build_keys.dim() == 1:
        return ref.merge_probe_ref(build_keys, probe_keys)
    return ref.merge_probe_multi_ref(build_keys, probe_keys)


def sample_plan(m: int, w: int) -> tuple[int, int]:
    """(stride, n_samples): the kernel's sample is build[j * stride] for
    j < n_samples, at most ``SAMPLE_BYTES`` of keys (4096 at W = 1, 2048
    at W = 2, 1024 at W = 3 or 4: a power of two), so that
    (n_samples - 1) * stride < m <= n_samples * stride."""
    if m == 0:
        return 1, 0
    cap = 1 << ((SAMPLE_BYTES // (8 * w)).bit_length() - 1)
    stride = -(-m // cap)
    return stride, -(-m // stride)


def _check(build_keys: torch.Tensor, probe_keys: torch.Tensor) -> int:
    if build_keys.device.type != "cuda" or (
            probe_keys.device != build_keys.device):
        raise ValueError(
            f"merge_probe: build on {build_keys.device}, probe on "
            f"{probe_keys.device}; the kernel takes one CUDA device")
    if build_keys.dtype != torch.int64 or probe_keys.dtype != torch.int64:
        raise TypeError("merge_probe: keys must be int64")
    if build_keys.dim() != probe_keys.dim() or build_keys.dim() not in (1, 2):
        raise ValueError("merge_probe: keys must both be [rows] or "
                         "both [rows, W]")
    w = 1 if build_keys.dim() == 1 else build_keys.shape[1]
    if build_keys.dim() == 2 and probe_keys.shape[1] != w:
        raise ValueError("merge_probe: build and probe word counts differ")
    if not 1 <= w <= MAX_WORDS:
        raise ValueError(f"merge_probe: W = {w} outside 1..{MAX_WORDS}")
    if not (build_keys.is_contiguous() and probe_keys.is_contiguous()):
        raise ValueError("merge_probe: keys must be contiguous")
    if build_keys.shape[0] > torch.iinfo(torch.int32).max:
        raise ValueError("merge_probe: int32 ranks need m < 2**31")
    return w


def merge_probe(build_keys: torch.Tensor, probe_keys: torch.Tensor,
                upper: bool = True):
    """int32 ranks of ``probe_keys`` in sorted ``build_keys``: (lo, hi),
    or lo alone when ``upper`` is False. Keys are [rows] int64 or
    [rows, W] int64 words under word-wise lexicographic order."""
    if _build.runs_plain(build_keys, probe_keys):
        lo, hi = merge_probe_plain(build_keys, probe_keys)
        return (lo, hi) if upper else lo
    w = _check(build_keys, probe_keys)
    n = probe_keys.shape[0]
    dev = probe_keys.device
    lo = torch.empty((n,), dtype=torch.int32, device=dev)
    hi = torch.empty((n,), dtype=torch.int32, device=dev) if upper else None
    if n:
        lib = _fn()
        m = build_keys.shape[0]
        stride, n_samples = sample_plan(m, w)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.merge_probe(
                build_keys.data_ptr(), m, probe_keys.data_ptr(), n, w,
                stride, n_samples, lo.data_ptr(),
                hi.data_ptr() if upper else None, stream)
        _build.check(rc, "merge_probe")
        _build.count_launch(LAUNCHES, "probe" if w == 1 else "probe_multi")
    return (lo, hi) if upper else lo


def _fn():
    lib = _build.load("merge_probe")
    f = lib.merge_probe
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
    return lib
