"""Plain torch versions of the port's kernels — the semantics the
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
    ascending (out of range = dropped). int32 sums wrap. A dropped row
    enters as the op's identity at a clamped id, so that no step depends
    on the values' count (the meta device of a dry run runs it too)."""
    if op not in ("sum", "min", "max"):
        raise ValueError(op)
    identity = _identity(op, values.dtype)
    out = torch.full((num_segments,) + tuple(values.shape[1:]), identity,
                     dtype=values.dtype, device=values.device)
    if num_segments == 0:
        return out
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = seg_ids.clamp(0, num_segments - 1).to(torch.int64)
    src = torch.where(keep.reshape((-1,) + (1,) * (values.dim() - 1)),
                      values, torch.tensor(identity, dtype=values.dtype,
                                           device=values.device))
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


# -- attention (the LM serving path) ------------------------------------------

def _attn_scale(d: int) -> torch.Tensor:
    """1 / sqrt(d) in float32, as the JAX reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def _softmax_or_zero(logits: torch.Tensor, visible: torch.Tensor):
    """f32 softmax over the last axis; a row with no visible entry gives
    0 (the kernels' contract; the JAX reference gives NaN there)."""
    logits = logits.masked_fill(~visible, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.where(visible.any(dim=-1, keepdim=True), w,
                       torch.zeros((), dtype=w.dtype, device=w.device))


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """float32, or float64 for float64 inputs (the gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _attn_logits(q, k, causal, scale):
    """(scaled logits [b, hq, sq, skv] in the compute dtype, visible
    [sq, skv]) of GQA attention: KV heads repeated over their group; the
    causal mask aligned to the end (query row i sees keys j <= i + skv -
    sq)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    kk = k.repeat_interleave(hq // hkv, dim=1).to(ct)
    if scale is None:
        scale = (_attn_scale(d) if ct == torch.float32
                 else 1.0 / torch.sqrt(torch.tensor(float(d), dtype=ct)))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), kk) * scale
    visible = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        visible = visible.tril(skv - sq)
    return logits, visible


def _attn_out(w, v, hq, dtype):
    vv = v.repeat_interleave(hq // v.shape[1], dim=1).to(w.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale=None) -> torch.Tensor:
    """q [b, hq, sq, d]; k, v [b, hkv, skv, d]; GQA: hq % hkv == 0, by
    repeating KV heads. f32 softmax (f64 for f64 inputs); the causal mask
    is aligned to the end (query row i sees keys j <= i + skv - sq).
    Output in q's dtype."""
    logits, visible = _attn_logits(q, k, causal, scale)
    return _attn_out(_softmax_or_zero(logits, visible), v, q.shape[1],
                     q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_chunk: int = 2048,
                        kv_chunk: int = 2048) -> torch.Tensor:
    """``attention_ref`` computed over q x kv blocks of at most
    ``q_chunk`` x ``kv_chunk`` with an online softmax in float32 (float64
    for float64 inputs), so that no [sq, skv] score matrix is built: the
    plain version at long sequences, after the reference's
    ``blockwise_attention``. Its causal alignment (query row i sees keys
    j <= i + skv - sq) and its skipping of blocks that the mask hides
    whole are kept. Unlike the reference's, which covers only the
    multiples of its chunk counts and drops the rest, the last block of
    each axis takes the remainder, so every row and key counts; a row
    that sees no key gives 0, as ``attention_ref`` does.

    A query block's GQA group shares each KV head's block as the rows of
    one batched product (no repeat of K and V), and each step updates its
    scores, running max, sum and accumulator in place."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    ct = _compute_dtype(q)
    scale = (_attn_scale(d) if ct == torch.float32
             else 1.0 / torch.sqrt(torch.tensor(float(d), dtype=ct)))
    scale = scale.to(q.device)
    offset = skv - sq
    bh = b * hkv
    outs = []
    for qs in range(0, sq, q_chunk):
        qn = min(q_chunk, sq - qs)
        qb = q[:, :, qs:qs + qn].to(ct).reshape(bh, group * qn, d)
        m = torch.full((bh, group * qn), float("-inf"), dtype=ct,
                       device=q.device)
        l = torch.zeros((bh, group * qn), dtype=ct, device=q.device)
        acc = torch.zeros((bh, group * qn, d), dtype=ct, device=q.device)
        for ks in range(0, skv, kv_chunk):
            if causal and ks > qs + offset + qn - 1:
                break                     # this block and the rest hidden
            kn = min(kv_chunk, skv - ks)
            kb = k[:, :, ks:ks + kn].to(ct).reshape(bh, kn, d)
            vb = v[:, :, ks:ks + kn].to(ct).reshape(bh, kn, d)
            s = torch.bmm(qb, kb.transpose(1, 2)).mul_(scale)
            if causal and ks + kn - 1 > qs + offset:   # on the diagonal
                qpos = torch.arange(qs + offset, qs + offset + qn,
                                    device=q.device)
                kpos = torch.arange(ks, ks + kn, device=q.device)
                s.view(bh, group, qn, kn).masked_fill_(
                    kpos[None, :] > qpos[:, None], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # rows that have seen no key yet keep m = -inf: shift by 0
            shift = torch.nan_to_num(m_new, neginf=0.0)
            p = s.sub_(shift[..., None]).exp_()
            alpha = m.sub_(shift).exp_()
            l.mul_(alpha).add_(p.sum(dim=-1))
            acc.mul_(alpha[..., None]).add_(torch.bmm(p, vb))
            m = m_new
        acc /= torch.where(l == 0, torch.ones((), dtype=ct, device=q.device),
                           l)[..., None]
        outs.append(acc.reshape(b, hq, qn, d).to(q.dtype))
    return torch.cat(outs, dim=2) if outs else torch.empty_like(q)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale=None):
    """``attention_ref``'s output and, per query row, the natural
    log-sum-exp of its visible scaled logits: lse [b, hq, sq] float32
    (float64 for float64 inputs), -inf for a row that sees no key (its
    output is 0)."""
    logits, visible = _attn_logits(q, k, causal, scale)
    lse = torch.logsumexp(logits.masked_fill(~visible, float("-inf")), -1)
    out = _attn_out(_softmax_or_zero(logits, visible), v, q.shape[1],
                    q.dtype)
    return out, lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                      causal: bool = True, scale=None):
    """Gradients (dq, dk, dv) of ``attention_ref`` at output ``o`` with
    output gradient ``do``, step by step as the backward kernels take
    them, in float32 (float64 for float64 inputs): P = exp(S - lse)
    recomputed from the saved log-sum-exp (0 where masked and in a row
    with lse = -inf), D = rowsum(dO * O), dV = P^T dO, dP = dO V^T,
    dS = P * (dP - D), dQ = scale dS K, dK = scale dS^T Q; GQA's dK and
    dV summed over each KV head's group. Returned in the inputs'
    dtypes."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    logits, visible = _attn_logits(q, k, causal, scale)
    ct = logits.dtype
    if scale is None:
        scale = (_attn_scale(d) if ct == torch.float32
                 else 1.0 / torch.sqrt(torch.tensor(float(d), dtype=ct)))
    lse = lse.to(ct)[..., None]
    live = visible & torch.isfinite(lse)
    p = torch.where(live, torch.exp(logits - torch.where(
        torch.isfinite(lse), lse, torch.zeros((), dtype=ct,
                                              device=q.device))),
        torch.zeros((), dtype=ct, device=q.device))
    do_, o_ = do.to(ct), o.to(ct)
    kk = k.repeat_interleave(group, dim=1).to(ct)
    vv = v.repeat_interleave(group, dim=1).to(ct)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do_)
    dp = torch.einsum("bhqd,bhkd->bhqk", do_, vv)
    delta = (do_ * o_).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ct)) * scale

    def group_sum(x):
        return x.reshape(b, hkv, group, skv, d).sum(2)
    return (dq.to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


def attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """``attention_ref`` computed in float64 with the exact scale
    1 / sqrt(d), returned in float64: the yardstick for how close a
    float32 path comes (float32 itself is off it by about the f32
    tolerance once scores span tens of units)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kk = k.repeat_interleave(hq // hkv, dim=1).double()
    vv = v.repeat_interleave(hq // hkv, dim=1).double()
    logits = q.double() @ kk.transpose(-1, -2) / d ** 0.5
    visible = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        visible = visible.tril(skv - sq)
    return _softmax_or_zero(logits, visible) @ vv


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len, scale=None) -> torch.Tensor:
    """One query token per sequence: q [b, hq, d]; k, v [b, hkv, S, d];
    positions >= kv_len (an int or [b] int32) are masked; kv_len = 0
    gives 0. Output in q's dtype."""
    b, hq, d = q.shape
    hkv, S = k.shape[1], k.shape[2]
    group = hq // hkv
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    scale = _attn_scale(d) if scale is None else scale
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kk) * scale
    pos = torch.arange(S, device=q.device)
    if isinstance(kv_len, int):
        visible = (pos < kv_len)[None, None, :]
    else:
        visible = pos[None, None, :] < kv_len.to(q.device)[:, None, None]
    w = _softmax_or_zero(logits, visible.expand(b, hq, S))
    return torch.einsum("bhs,bhsd->bhd", w, vv).to(q.dtype)


# -- FM interaction (the recsys serve path) -----------------------------------

def _fm_sums(x: torch.Tensor, v: torch.Tensor):
    """Per row and factor column, in float32 (float64 for float64
    inputs): (sum_f p, sum_f p^2) with p = x_f v_fk; v [f, k] or
    [b, f, k]."""
    ct = _compute_dtype(x)
    p = x.to(ct)[:, :, None] * v.to(ct)
    return p.sum(dim=1), (p * p).sum(dim=1)


def fm_interaction_ref(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """FM 2-way term [Rendle ICDM'10]: x [b, f] feature values; v [f, k]
    factor embeddings shared by every row, or [b, f, k], one factor
    matrix per row (the reference's ``jax.vmap`` written out). Computes
    in float32, with p = x_f v_fk,
        0.5 * sum_k ((sum_f p)^2 - sum_f p^2),
    and returns [b] in x's dtype."""
    s, q = _fm_sums(x, v)
    return (0.5 * (s * s - q).sum(dim=-1)).to(x.dtype)


def fm_interaction_bwd_ref(x: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor):
    """Gradients (dx [b, f], dv) of ``fm_interaction_ref`` under output
    gradient g [b], in float32 (float64 for float64 inputs), with
    S_k = sum_f x_f v_fk:
        dv_fk = g x_f (S_k - x_f v_fk),  dx_f = g sum_k v_fk (S_k - x_f v_fk);
    dv is [b, f, k] for a per-row v and summed over rows for a shared
    [f, k]. Returned in the inputs' dtypes."""
    ct = _compute_dtype(x)
    x_, v_, g_ = x.to(ct), v.to(ct), g.to(ct)
    vb = v_ if v.dim() == 3 else v_[None]
    s = (x_[:, :, None] * vb).sum(dim=1, keepdim=True)          # [b, 1, k]
    r = s - x_[:, :, None] * vb                                 # [b, f, k]
    dv = g_[:, None, None] * x_[:, :, None] * r
    dx = g_[:, None] * (vb * r).sum(dim=-1)
    if v.dim() == 2:
        dv = dv.sum(dim=0)
    return dx.to(x.dtype), dv.to(v.dtype)


def fm_allowed_error(x: torch.Tensor, v: torch.Tensor,
                     want: torch.Tensor) -> torch.Tensor:
    """[b] float32: how far a float32 computation of
    ``fm_interaction_ref(x, v)`` (= ``want``) may lie from it. The trick
    subtracts two terms of size c = 0.5 * sum_k ((sum_f p)^2 + sum_f
    p^2); sums in another order differ by a few float32 units of c, so
    1e-5 * c + 1e-7. A bfloat16 output may also round to the neighbour:
    one bfloat16 unit of ``want`` more."""
    s, q = _fm_sums(x, v)
    allowed = 1e-5 * (0.5 * (s * s + q).sum(dim=-1)) + 1e-7
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(1e-30)
        allowed = allowed + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return allowed
