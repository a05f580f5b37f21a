"""Kernel-dispatch layer — the seam between the engine's logical
operators (relops.py) and their physical implementations.

The hot primitives of the fixpoint (see ``repro.engine.backend``):

  probe(build, probe) -> (lo, hi)
      int32 lower/upper ranks of int64 probe keys in sorted int64 build
      keys: the join's count/locate, the membership test behind
      semijoin/antijoin/difference, the lattice lookup of
      ``merge_with_delta``.
  probe_multi(build_words, probe_words) -> (lo, hi)
      The same ranks for [*, W] int64 word vectors (multi-word keys).
  segment_reduce(values, seg_ids, num_segments, op)
      Sorted-segment sum/min/max: ``dedupe``'s duplicate-combine for
      valued semirings and ``reduce_groups``.
  merge_ranks(a_keys, b_keys) -> (pos_a, pos_b)
      Stable two-pointer merge positions (a wins ties); the default
      derivation runs the probe once per side.
  expand(offsets, out_cap)
      The join's bounded expand; a torch op on every dispatch.

Two dispatches:

  * ``TorchDispatch`` — the plain torch versions (``kernels/ref.py``);
    serves CPU tensors only.
  * ``CudaDispatch``  — the hand-written CUDA kernels (``csrc/``);
    serves CUDA tensors only.

Neither needs sorted probe keys (both search per key), so
``relops.membership`` probes its unsorted side directly. Both return
exact ``searchsorted`` ranks for every probe, KEY_PAD included.
``resolve_backend("auto", device)`` follows the device, so an engine on
a CUDA device always runs the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.engine.observe import trace_count
from repro_torch.kernels import ref
from repro_torch.kernels.merge_probe import merge_probe
from repro_torch.kernels.segment_reduce import segment_reduce


class KernelDispatch:
    """Injected probe/reduce implementations for the engine hot path."""

    name = "abstract"
    # True if ``probe`` requires ascending probe keys; relops.membership
    # then sorts-and-scatters its probe side
    needs_sorted_probe = False

    def _count(self, op: str) -> None:
        """Per-call counter ``kernel.<backend>.<op>`` in
        observe.REGISTRY (the reference counts once per compilation)."""
        trace_count(f"kernel.{self.name}.{op}")

    def probe(self, build_keys: torch.Tensor, probe_keys: torch.Tensor):
        raise NotImplementedError

    def probe_lo(self, build_keys, probe_keys):
        return self.probe(build_keys, probe_keys)[0]

    def probe_multi(self, build_words, probe_words):
        raise NotImplementedError

    def probe_lo_multi(self, build_words, probe_words):
        return self.probe_multi(build_words, probe_words)[0]

    def segment_reduce(self, values, seg_ids, num_segments: int, op: str):
        raise NotImplementedError

    def merge_ranks(self, a_keys, b_keys):
        """pos_a[i] = i + #{b < a[i]}, pos_b[j] = j + #{a <= b[j]}."""
        lo_a = self.probe_lo(b_keys, a_keys)
        _, hi_b = self.probe(a_keys, b_keys)
        return ref._positions(lo_a, hi_b)

    def merge_ranks_multi(self, a_words, b_words):
        lo_a = self.probe_lo_multi(b_words, a_words)
        _, hi_b = self.probe_multi(a_words, b_words)
        return ref._positions(lo_a, hi_b)

    def expand(self, offsets, out_cap: int):
        self._count("expand")
        return ref.expand_indices_ref(offsets, out_cap)

    def __repr__(self):
        return f"<KernelDispatch {self.name}>"


class TorchDispatch(KernelDispatch):
    """The plain torch versions, for CPU tensors."""

    name = "torch"

    def _cpu(self, *ts):
        for t in ts:
            if t.device.type != "cpu":
                raise ValueError(
                    f"TorchDispatch serves CPU tensors; got {t.device} "
                    f"(CUDA tensors go through CudaDispatch)")

    def probe(self, build_keys, probe_keys):
        self._cpu(build_keys, probe_keys)
        self._count("probe")
        return ref.merge_probe_ref(build_keys, probe_keys)

    def probe_multi(self, build_words, probe_words):
        self._cpu(build_words, probe_words)
        self._count("probe_multi")
        return ref.merge_probe_multi_ref(build_words, probe_words)

    def segment_reduce(self, values, seg_ids, num_segments, op):
        self._cpu(values, seg_ids)
        self._count("segment_reduce")
        return ref.segment_reduce_ref(values, seg_ids, num_segments, op)


class CudaDispatch(KernelDispatch):
    """The hand-written CUDA kernels, for CUDA tensors."""

    name = "cuda"

    def _cuda(self, *ts):
        for t in ts:
            if t.device.type != "cuda":
                raise ValueError(
                    f"CudaDispatch serves CUDA tensors; got {t.device}")

    def probe(self, build_keys, probe_keys):
        self._cuda(build_keys, probe_keys)
        self._count("probe")
        return merge_probe(build_keys.contiguous(), probe_keys.contiguous())

    def probe_lo(self, build_keys, probe_keys):
        self._cuda(build_keys, probe_keys)
        self._count("probe_lo")
        return merge_probe(build_keys.contiguous(), probe_keys.contiguous(),
                           upper=False)

    def probe_multi(self, build_words, probe_words):
        self._cuda(build_words, probe_words)
        self._count("probe_multi")
        return merge_probe(build_words.contiguous(),
                           probe_words.contiguous())

    def probe_lo_multi(self, build_words, probe_words):
        self._cuda(build_words, probe_words)
        self._count("probe_lo_multi")
        return merge_probe(build_words.contiguous(),
                           probe_words.contiguous(), upper=False)

    def segment_reduce(self, values, seg_ids, num_segments, op):
        self._cuda(values, seg_ids)
        self._count("segment_reduce")
        return segment_reduce(values.contiguous(), seg_ids.contiguous(),
                              num_segments, op)


TORCH = TorchDispatch()
CUDA = CudaDispatch()

_CHOICES = ("auto", "torch", "cuda")


def resolve_backend(spec: "str | KernelDispatch | None" = "auto",
                    device="cuda") -> KernelDispatch:
    """Resolve a dispatch spec once, at engine construction. "auto"
    follows ``device``: CUDA runs the kernels, CPU the plain versions."""
    if isinstance(spec, KernelDispatch):
        return spec
    spec = spec or "auto"
    if spec == "auto":
        spec = "cuda" if torch.device(device).type == "cuda" else "torch"
    if spec == "torch":
        return TORCH
    if spec == "cuda":
        return CUDA
    raise ValueError(f"kernel backend {spec!r}: expected one of {_CHOICES}")
