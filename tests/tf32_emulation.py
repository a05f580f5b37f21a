"""The tensor core's TF32 arithmetic, emulated in torch on the CPU: the
helpers that tests/test_torch_tf32_split.py (the float32 prefill) and
tests/test_torch_tf32_bwd_split.py (its backward) share.

A tensor core in TF32 mode reads an f32 register and ignores its low 13
bits. The kernels split x into hi = cvt.rna.tf32.f32(x) (round to
nearest, ties away, the low 13 bits cleared) and lo = x - hi, which the
tensor core truncates to TF32, and compute a . b as lo_a hi_b + hi_a
lo_b + hi_a hi_b. Their mma instructions are modelled as the published
studies of NVIDIA tensor cores describe them: exact products, their sum
added to the f32 accumulator rounding toward zero."""
import torch

# The float32 attention backward kernels' geometry
# (csrc/flash_attention_bwd_tf32.cu), by head dim, which
# tests/test_torch_tf32_bwd_split.py emulates: "cta_cols", the columns of
# d one CTA holds (d at 64 and 128; at 256 a cluster of two CTAs each sums
# its 128 columns of S^T, dP^T, S and dP as below and the two partials are
# added once in f32); "kg", the k-steps of 8 of S^T, dP^T, S and dP that
# go into one fresh fragment within a CTA (the source's KG); "kv_rows",
# the query rows of a dK/dV stage, and "q_keys", the keys of a dQ stage,
# each stage's P^T dO, dS^T Q or dS K a fresh fragment added to dV, dK or
# dQ (R = 2048 / cta_cols); "kv_cols" and "q_cols", the columns of d that
# one such fragment of dV, dK and of dQ spans (N = 64 blocks of dV and dK,
# one consumer's half of a CTA's dQ columns); "a_split", how the A
# operands (K, V, Q, dO in the first products; P^T, dS^T, dS in the
# second) are split: "rna" as ``split``, "trunc" as ``split_trunc`` (the
# kernels pass the raw value as hi). The B operands are always split by
# ``split``. At d = 16 and 32 the kernels are the mma.sync route
# (bwd_dkdv_mma, bwd_dq_mma): stages of KV_ROWS query rows and Q_KEYS
# keys, fresh fragments of up to 4 d steps, every operand split by rna.
BWD_GEOMETRY = {
    16: {"cta_cols": 16, "kg": 2, "kv_rows": 32, "q_keys": 32,
         "kv_cols": 16, "q_cols": 16, "a_split": "rna"},
    32: {"cta_cols": 32, "kg": 2, "kv_rows": 32, "q_keys": 32,
         "kv_cols": 32, "q_cols": 32, "a_split": "rna"},
    64: {"cta_cols": 64, "kg": 2, "kv_rows": 32, "q_keys": 32,
         "kv_cols": 64, "q_cols": 32, "a_split": "trunc"},
    128: {"cta_cols": 128, "kg": 2, "kv_rows": 16, "q_keys": 16,
          "kv_cols": 64, "q_cols": 64, "a_split": "trunc"},
    256: {"cta_cols": 128, "kg": 2, "kv_rows": 16, "q_keys": 16,
          "kv_cols": 64, "q_cols": 64, "a_split": "trunc"},
}

# the low 29 of a float64's 52 fraction bits: clearing them leaves a
# value with float32's 23, the float32 rounding toward zero
_F64_BELOW_F32 = ~((1 << 29) - 1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite float32: round to nearest, ties away
    from zero, to 10 fraction bits; the low 13 bits cleared."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a tensor core in TF32 mode reads of an f32 register: the
    low 13 bits dropped (truncation)."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """The kernels' split: hi exact in TF32, lo as the tensor core reads
    the f32 residual."""
    hi = tf32_rna(x)
    return hi, tf32_read(x - hi)


def split_trunc(x: torch.Tensor):
    """The split of an operand passed raw as hi: the tensor core reads it
    truncated, and lo = x - trunc(x) (exact in f32) is read truncated
    too."""
    hi = tf32_read(x)
    return hi, tf32_read(x - hi)


def toward_zero64(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> the float32 value toward zero, kept as float64 (exact
    for values in float32's normal range: the fraction truncated)."""
    return (x64.view(torch.int64) & _F64_BELOW_F32).view(torch.float64)


def toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounding toward zero."""
    return toward_zero64(x64).float()


def mma_sum(a_parts, b_parts, acc=None):
    """acc (+)= a . b over k steps of 8, three mma instructions a step
    (lo.hi, hi.lo, hi.hi), each adding its exact products to the f32
    accumulator rounding toward zero; acc None starts from 0."""
    (ah, al), (bh, bl) = ((p.double() for p in parts)
                          for parts in (a_parts, b_parts))
    shape = torch.broadcast_shapes(ah.shape[:-2], bh.shape[:-2]) + (
        ah.shape[-2], bh.shape[-1])
    out = (torch.zeros(shape, dtype=torch.float64) if acc is None
           else acc.double().expand(shape).clone())
    bits, prod = out.view(torch.int64), torch.empty_like(out)
    for k0 in range(0, ah.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            torch.matmul(x[..., ks], y[..., ks, :], out=prod)
            out.add_(prod)
            bits.bitwise_and_(_F64_BELOW_F32)    # toward zero, in place
    return out.float()
