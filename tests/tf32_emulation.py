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
