"""The port's plain attention versions (repro_torch.kernels.ref, and the
flash_attention / flash_decode wrappers on CPU tensors) against the JAX
package's references and its Pallas kernels in interpret mode, on the
same seeded inputs. Tolerances: float32 2e-5, bfloat16 2e-2 (the
reference's own kernel tests). bfloat16 inputs are rounded from the
same float32 draws on both sides, so they are equal bit for bit.

Contract gap: for a row with no visible key (kv_len = 0) the JAX
reference gives NaN and the Pallas kernel 0; the port follows the
kernel, so kv_len = 0 is compared against the interpret kernel only."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as jref
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dtype):
    x = rng.normal(size=shape).astype(np.float32)
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 4, 4, 128, 128, 64),        # MHA square
    (2, 8, 2, 128, 128, 64),        # GQA 4:1
    (1, 4, 1, 64, 256, 64),         # MQA, sq < skv (chunked prefill)
    (1, 16, 8, 256, 256, 32),       # GQA 2:1
    (1, 4, 2, 128, 128, 16),        # the smoke configs' head dim 16
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax(b, hq, hkv, sq, skv, d, causal,
                                           dtype):
    rng = np.random.default_rng(b * 1000 + sq + d)
    jq, tq = _pair(rng, (b, hq, sq, d), dtype)
    jk, tk = _pair(rng, (b, hkv, skv, d), dtype)
    jv, tv = _pair(rng, (b, hkv, skv, d), dtype)
    tol = DTYPES[dtype][2]
    got = FA.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), tol)
    _close(got, ops.flash_attention(jq, jk, jv, causal=causal,
                                    backend="interpret", q_block=64,
                                    kv_block=64), tol)
    torch.testing.assert_close(got, tref.attention_ref(tq, tk, tv, causal))


@pytest.mark.parametrize("sq,skv", [(37, 37), (5, 91), (1, 70)])
def test_flash_attention_plain_ragged_lengths(sq, skv):
    """Lengths that are no tile multiple (the Pallas kernel refuses
    them; the port's kernel masks the tails): against the reference."""
    rng = np.random.default_rng(sq)
    jq, tq = _pair(rng, (2, 4, sq, 64), "float32")
    jk, tk = _pair(rng, (2, 2, skv, 64), "float32")
    jv, tv = _pair(rng, (2, 2, skv, 64), "float32")
    for causal in (True, False):
        _close(FA.flash_attention(tq, tk, tv, causal=causal),
               jref.attention_ref(jq, jk, jv, causal=causal), 2e-5)


def test_flash_attention_rows_without_keys_give_zero():
    """sq > skv, causal: the first sq - skv rows see no key."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(1, 2, 8, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(1, 2, 3, 64)).astype(np.float32))
    out = FA.flash_attention(q, kv, kv, causal=True)
    assert torch.equal(out[:, :, :5], torch.zeros_like(out[:, :, :5]))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("b,hq,hkv,S,d", [
    (2, 4, 4, 512, 64), (1, 8, 2, 1024, 64), (3, 16, 8, 256, 128),
    (2, 4, 2, 256, 16), (1, 8, 2, 256, 32),   # the smoke head dims
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_jax(b, hq, hkv, S, d, dtype):
    rng = np.random.default_rng(b * 100 + S)
    jq, tq = _pair(rng, (b, hq, d), dtype)
    jk, tk = _pair(rng, (b, hkv, S, d), dtype)
    jv, tv = _pair(rng, (b, hkv, S, d), dtype)
    lens = rng.integers(1, S, size=(b,)).astype(np.int32)
    tol = DTYPES[dtype][2]
    got = FA.flash_decode(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           tol)
    _close(got, ops.flash_decode(jq, jk, jv, jnp.asarray(lens),
                                 backend="interpret", kv_block=128), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_empty_and_full_rows(dtype):
    """kv_len in {0, 1, S}: 0 against the interpret kernel (which gives
    0 there), 1 and S against the reference too; an int kv_len."""
    rng = np.random.default_rng(7)
    S = 256
    jq, tq = _pair(rng, (3, 4, 64), dtype)
    jk, tk = _pair(rng, (3, 2, S, 64), dtype)
    jv, tv = _pair(rng, (3, 2, S, 64), dtype)
    lens = np.array([0, 1, S], np.int32)
    tol = DTYPES[dtype][2]
    got = FA.flash_decode(tq, tk, tv, torch.from_numpy(lens))
    _close(got, ops.flash_decode(jq, jk, jv, jnp.asarray(lens),
                                 backend="interpret", kv_block=128), tol)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got[1:], jref.decode_attention_ref(
        jq[1:], jk[1:], jv[1:], jnp.asarray(lens[1:])), tol)
    _close(FA.flash_decode(tq, tk, tv, S),
           jref.decode_attention_ref(jq, jk, jv, S), tol)


def test_decode_splits_cover_the_cache():
    for b, hkv, S in [(8, 8, 2112), (8, 8, 32768), (1, 1, 5), (4, 2, 0),
                      (1, 16, 100000)]:
        n, split_len = FA.decode_splits(b, hkv, S)
        assert n >= 1 and split_len % 32 == 0
        assert n * split_len >= S and (n - 1) * split_len < max(S, 1)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    """These checks run before any build, so they hold without a card:
    inputs split between the meta device and the CPU stand in for inputs
    that are not on one CUDA device (all on the CPU, or all on meta as in
    a dry run, they take the plain version)."""
    q = torch.empty((1, 4, 8, 64), device="meta")
    k = torch.empty((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_decode(q[:, :, 0], k, k, 3)
