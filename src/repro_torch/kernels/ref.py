"""Plain torch versions of the engine's kernels — the semantics the
hand-written CUDA kernels must match. ``TorchDispatch`` runs these on
CPU tensors; the tests and ``chip_smoke.py`` hold the kernels against
them."""
from __future__ import annotations

import torch


def _identity(op: str, dtype: torch.dtype):
    """Empty-segment value per (op, dtype): 0 for sums, the iinfo or
    +-inf extremes for min/max (as ``jax.ops.segment_min/max`` give)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """values: [n] or [n, d] int32/float32; seg_ids: [n] int32 sorted
    ascending (out of range = dropped). int32 sums wrap."""
    if op not in ("sum", "min", "max"):
        raise ValueError(op)
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = seg_ids[keep].to(torch.int64)
    src = values[keep]
    out = torch.full((num_segments,) + tuple(values.shape[1:]),
                     _identity(op, values.dtype), dtype=values.dtype,
                     device=values.device)
    if op == "sum":
        return out.index_add_(0, idx, src)
    if values.dim() == 2:
        idx = idx[:, None].expand_as(src)
    return out.scatter_reduce_(0, idx, src,
                               reduce="amin" if op == "min" else "amax")


def merge_probe_ref(build_keys: torch.Tensor, probe_keys: torch.Tensor):
    """build_keys sorted ascending [m] int64; probe [n] int64 (any
    order). Returns int32 (lo, hi) = searchsorted left / right."""
    lo = torch.searchsorted(build_keys, probe_keys, side="left")
    hi = torch.searchsorted(build_keys, probe_keys, side="right")
    return lo.to(torch.int32), hi.to(torch.int32)


def _lex_lt_le(rows: torch.Tensor, query: torch.Tensor):
    """Word-wise lexicographic compare of [k, W] vs [k, W]:
    (rows < query, rows <= query)."""
    lt = torch.zeros(rows.shape[:-1], dtype=torch.bool, device=rows.device)
    eq = torch.ones(rows.shape[:-1], dtype=torch.bool, device=rows.device)
    for w in range(rows.shape[-1]):
        a, b = rows[..., w], query[..., w]
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return lt, lt | eq


def merge_probe_multi_ref(build_words: torch.Tensor,
                          probe_words: torch.Tensor):
    """Multi-word searchsorted: build_words [m, W] sorted ascending
    word-wise; probe_words [n, W] in any order. A vectorized binary
    search per side; returns int32 (lo, hi)."""
    m = build_words.shape[0]
    n = probe_words.shape[0]
    dev = probe_words.device
    steps = m.bit_length() if m else 0

    def search(upper: bool):
        lo = torch.zeros((n,), dtype=torch.int64, device=dev)
        hi = torch.full((n,), m, dtype=torch.int64, device=dev)
        for _ in range(steps):
            active = lo < hi
            mid = (lo + hi) >> 1
            rows = build_words[mid.clamp(max=m - 1)]
            lt, le = _lex_lt_le(rows, probe_words)
            pred = le if upper else lt
            lo = torch.where(active & pred, mid + 1, lo)
            hi = torch.where(active & ~pred, mid, hi)
        return lo.to(torch.int32)
    return search(False), search(True)


def merge_ranks_ref(a_keys: torch.Tensor, b_keys: torch.Tensor):
    """Output positions of a stable two-pointer merge of two sorted key
    sequences (``a`` wins ties): pos_a[i] = i + #{b < a[i]},
    pos_b[j] = j + #{a <= b[j]}."""
    lo_a, _ = merge_probe_ref(b_keys, a_keys)
    _, hi_b = merge_probe_ref(a_keys, b_keys)
    return _positions(lo_a, hi_b)


def merge_ranks_multi_ref(a_words: torch.Tensor, b_words: torch.Tensor):
    """Multi-word ``merge_ranks_ref`` over [m, W] / [n, W] key words."""
    lo_a, _ = merge_probe_multi_ref(b_words, a_words)
    _, hi_b = merge_probe_multi_ref(a_words, b_words)
    return _positions(lo_a, hi_b)


def _positions(lo_a: torch.Tensor, hi_b: torch.Tensor):
    pos_a = torch.arange(lo_a.shape[0], dtype=torch.int32,
                         device=lo_a.device) + lo_a
    pos_b = torch.arange(hi_b.shape[0], dtype=torch.int32,
                         device=hi_b.device) + hi_b
    return pos_a, pos_b


def expand_indices_ref(offsets: torch.Tensor, out_cap: int):
    """The join's bounded 'repeat': output slot j maps to input row
    i = searchsorted(offsets, j, 'right') with within-group index
    j - offsets[i-1]. Returns (row_idx, within_idx, valid, total)."""
    total = offsets[-1]
    j = torch.arange(out_cap, dtype=offsets.dtype, device=offsets.device)
    i = torch.searchsorted(offsets, j, side="right")
    prev = torch.where(i > 0, offsets[(i - 1).clamp(min=0)],
                       torch.zeros((), dtype=offsets.dtype,
                                   device=offsets.device))
    within = j - prev
    valid = j < total
    return i, within, valid, total
