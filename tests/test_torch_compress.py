"""The port's gradient compression (repro_torch.training.compress)
against the JAX package's on the CPU. Deterministic int8 and top-k with
error feedback must match exactly: inputs of distinct magnitudes, so that
top-k's order of ties cannot differ. Stochastic rounding draws other
random bits than jax.random, so it is held to bounds: each value within
one quantisation step of the input, and unbiased (the mean error over
many draws within 4 standard errors of 0)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compress as JC
from repro_torch.training import compress as C


def _distinct(rng, shape, scale=1.0):
    """Values of distinct magnitudes: a permutation of 1..n, random signs,
    scaled."""
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1).astype(np.float32) / n
    signs = rng.choice([-1.0, 1.0], size=n).astype(np.float32)
    return (mags * signs * scale).reshape(shape)


def _grads(rng, step=0):
    """Gradients of distinct magnitudes; a later step's on another,
    incommensurate grid, so that a gradient plus the fed-back residual
    (the earlier steps' values) keeps distinct magnitudes too."""
    f = (2 ** 0.5 / 3) ** step
    return {"a": _distinct(rng, (64,), 3.0 * f),
            "layers": {"w": _distinct(rng, (2, 8, 16), 0.01 * f)},
            "z": _distinct(rng, (5, 7), 100.0 * f)}


def _torch(tree, dtype=torch.float32):
    return C.tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("shape,scale", [((128,), 3.0), ((4, 33), 1e-3),
                                         ((7,), 1e4)])
def test_quantize_int8_matches_reference(shape, scale):
    x = _distinct(np.random.default_rng(0), shape, scale)
    q, s = C.quantize_int8(torch.from_numpy(x))
    wq, ws = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        C.dequantize_int8(q, s).numpy(),
        np.asarray(JC.dequantize_int8(wq, ws)))


def test_int8_quantization_error_bound():
    """The reference's bound: deterministic rounding within half a step."""
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(128,)).astype(np.float32) * 3)
    q, s = C.quantize_int8(x)
    assert float((C.dequantize_int8(q, s) - x).abs().max()) <= (
        float(s) * 0.51 + 1e-6)


def test_stochastic_rounding_bounds():
    x = torch.from_numpy(_distinct(np.random.default_rng(1), (1000,), 2.0))
    gen = torch.Generator().manual_seed(0)
    errs = []
    for _ in range(200):
        q, s = C.quantize_int8(x, gen)
        err = C.dequantize_int8(q, s) - x
        assert float(err.abs().max()) <= float(s) * (1 + 1e-6)
        errs.append(err)
    mean = torch.stack(errs).mean(0)
    # each draw's error has sd <= s / 2: its mean over 200 draws <= s / 28
    assert float(mean.abs().mean()) < 4 * float(s) / (2 * 200 ** 0.5)


@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
def test_topk_with_error_feedback_matches_reference(density):
    rng = np.random.default_rng(2)
    g = _grads(rng)
    state = C.init_state(_torch(g), "topk")
    jstate = JC.init_state(_jax(g), "topk")
    for step in range(3):
        g = _grads(rng, step) if step else g
        for gl, r in zip(C.tree_leaves(_torch(g)),
                         C.tree_leaves(state.residual)):
            mags = (gl + r).abs().flatten()
            assert mags.unique().numel() == mags.numel()   # no ties
        out, state, wire = C.compress_grads(_torch(g), state, "topk",
                                            density=density)
        wout, jstate, wwire = JC.compress_grads(_jax(g), jstate, "topk",
                                                density=density)
        assert wire == wwire
        for a, b in zip(C.tree_leaves(out), jax.tree.leaves(wout)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(C.tree_leaves(state.residual),
                        jax.tree.leaves(jstate.residual)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_and_none_schemes_match_reference(dtype):
    g = _grads(np.random.default_rng(3))
    tg, jg = _torch(g, getattr(torch, dtype)), _jax(g, jnp.dtype(dtype))
    for scheme in ("none", "int8"):
        out, _, wire = C.compress_grads(tg, C.CompressionState(None), scheme)
        wout, _, wwire = JC.compress_grads(jg, JC.CompressionState(None),
                                           scheme)
        assert wire == wwire
        for a, b in zip(C.tree_leaves(out), jax.tree.leaves(wout)):
            assert str(a.dtype).endswith(dtype)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
    with pytest.raises(ValueError, match="scheme"):
        C.compress_grads(tg, C.CompressionState(None), "fp4")
