"""The port's blockwise attention (repro_torch.kernels.ref) and the plain
prefill's switch to it (kernels.flash_attention.flash_attention_plain)
against the JAX package's blockwise_attention and ops.flash_attention,
on the same seeded inputs. Tolerances: float32 2e-5, bfloat16 2e-2 (the
reference's own kernel tests, as tests/test_torch_attention.py).

Contract gap: the reference's blockwise_attention cuts each axis into
``len // chunk`` equal blocks and drops the remainder, so at lengths that
its chunk counts do not divide it returns fewer query rows than it was
given, or leaves the last keys out. The port's last block takes the
remainder; it is compared with the reference only at lengths the
reference covers, and with its own attention_ref everywhere."""
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


@pytest.mark.parametrize("hq,hkv", [(4, 2), (8, 2)])      # GQA 2:1, 4:1
@pytest.mark.parametrize("sq,skv", [(128, 256), (192, 192), (64, 320)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_matches_the_reference_blockwise(hq, hkv, sq, skv, causal,
                                                   dtype):
    """Chunks of 64, at lengths that are multiples of them (the lengths
    the reference covers whole)."""
    rng = np.random.default_rng(sq * 7 + skv + hq)
    jq, tq = _pair(rng, (2, hq, sq, 32), dtype)
    jk, tk = _pair(rng, (2, hkv, skv, 32), dtype)
    jv, tv = _pair(rng, (2, hkv, skv, 32), dtype)
    got = tref.blockwise_attention(tq, tk, tv, causal=causal, q_chunk=64,
                                   kv_chunk=64)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jref.blockwise_attention(jq, jk, jv, causal=causal, q_chunk=64,
                                    kv_chunk=64)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,chunks,causal", [
    (1, 2, 1, 5, 5, (2, 2), True),          # a remainder row and key
    (1, 4, 2, 4, 5, (2, 2), False),         # a remainder key
    (2, 4, 2, 37, 100, (16, 32), True),     # remainders, sq < skv
    (2, 2, 2, 100, 37, (16, 8), True),      # sq > skv: rows without keys
    (1, 1, 1, 3, 4097, (2048, 2048), True),   # the default chunks
    (1, 2, 1, 0, 5, (2, 2), True),          # no query
    (1, 2, 1, 3, 0, (2, 2), False),         # no key
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_blockwise_covers_every_row_and_key(b, hq, hkv, sq, skv, chunks,
                                            causal, dtype):
    """The port's blockwise equals its attention_ref at lengths that the
    reference's drops rows or keys at (float32 2e-5, float64 1e-12,
    bfloat16 one unit in the last place of the output)."""
    g = torch.Generator().manual_seed(sq + skv)
    q = torch.randn((b, hq, sq, 16), generator=g).to(dtype)
    k = torch.randn((b, hkv, skv, 16), generator=g).to(dtype)
    v = torch.randn((b, hkv, skv, 16), generator=g).to(dtype)
    got = tref.blockwise_attention(q, k, v, causal, *chunks)
    want = tref.attention_ref(q, k, v, causal)
    assert got.shape == want.shape and got.dtype == dtype
    tol = {torch.float32: (2e-5, 2e-5), torch.float64: (1e-12, 1e-12),
           torch.bfloat16: (1e-2, 1e-4)}[dtype]
    torch.testing.assert_close(got, want, rtol=tol[0], atol=tol[1])


def test_the_reference_blockwise_drops_rows_and_keys():
    """The gap, shown on the reference: at sq = skv = 5 with chunks of 2
    it returns 4 rows of 5; at sq = 4, skv = 5 (not causal) it leaves the
    last key out, and its output is far from attention_ref's; at skv =
    4097 with its default chunks the last key is dropped too."""
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (1, 2, 5, 16), "float32")
    jk, tk = _pair(rng, (1, 1, 5, 16), "float32")
    jv, tv = _pair(rng, (1, 1, 5, 16), "float32")
    assert jref.blockwise_attention(jq, jk, jv, True, 2, 2).shape[2] == 4
    assert tref.blockwise_attention(tq, tk, tv, True, 2, 2).shape[2] == 5
    jq4, tq4 = jq[:, :, :4], tq[:, :, :4]
    dropped = jref.blockwise_attention(jq4, jk, jv, False, 2, 2)
    exact = jref.attention_ref(jq4, jk, jv, causal=False)
    assert float(jnp.abs(dropped - exact).max()) > 0.1
    _close(tref.blockwise_attention(tq4, tk, tv, False, 2, 2), exact, 2e-5)
    jq, tq = _pair(rng, (1, 1, 3, 16), "float32")
    jk, tk = _pair(rng, (1, 1, 4097, 16), "float32")
    jv = jnp.zeros((1, 1, 4097, 16), jnp.float32).at[:, :, -1].set(100.0)
    tv = torch.from_numpy(np.array(jv))
    # the last query row sees every key; only key 4096's value is not 0
    assert float(jnp.abs(jref.blockwise_attention(jq, jk, jv, True)).max()
                 ) == 0.0
    assert float(tref.blockwise_attention(tq, tk, tv, True)[0, 0, -1]
                 .abs().max()) > 0.0


def test_flash_attention_switches_to_blockwise_at_4096_keys(monkeypatch):
    """flash_attention on the CPU at skv = 4096 (1 head, d 16) against
    the reference's ops.flash_attention(backend="xla"), which takes its
    blockwise there; the port's plain route takes its own, and
    attention_ref below 4096 keys."""
    rng = np.random.default_rng(4096)
    jq, tq = _pair(rng, (1, 1, 4096, 16), "float32")
    jk, tk = _pair(rng, (1, 1, 4096, 16), "float32")
    jv, tv = _pair(rng, (1, 1, 4096, 16), "float32")
    calls = []
    blockwise = tref.blockwise_attention

    def counted(*args, **kw):
        calls.append(args[1].shape[2])
        return blockwise(*args, **kw)

    monkeypatch.setattr(tref, "blockwise_attention", counted)
    assert FA.BLOCKWISE_THRESHOLD == ops.XLA_BLOCKWISE_THRESHOLD == 4096
    got = FA.flash_attention(tq, tk, tv, causal=True)
    _close(got, ops.flash_attention(jq, jk, jv, causal=True, backend="xla"),
           2e-5)
    assert calls == [4096]
    short = FA.flash_attention(tq[:, :, :64], tk[:, :, :4095],
                               tv[:, :, :4095], causal=True)
    assert calls == [4096]
    torch.testing.assert_close(short, tref.attention_ref(
        tq[:, :, :64], tk[:, :, :4095], tv[:, :, :4095], True))
