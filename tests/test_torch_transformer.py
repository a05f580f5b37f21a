"""The port's transformer (repro_torch.models) against the JAX package's
on the CPU: the building blocks of models.common at 1e-6, and prefill
plus greedy decode of the LM smoke configs (dense and MoE) with the
reference's weights carried over by ``params_from_numpy``, and
granite-moe-1b-a400m at full width with one layer.

Logits are held at atol = rtol = 1e-4 in float32 and at 2e-2 of their
scale in bfloat16; greedy tokens must be identical. The JAX side runs
with attn_backend "xla" (its plain attention) and "interpret" (its
Pallas kernels in interpret mode, which need a cache capacity that is a
block multiple)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import common as jc
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import common as tc
from repro_torch.models import transformer as T

SMOKE_ARCHS = ("qwen3-1.7b", "chatglm3-6b", "gemma-7b")
MOE_ARCHS = ("granite-moe-3b-a800m", "granite-moe-1b-a400m")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- models.common ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 5, 4, 16)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    g = rng.normal(size=shape[-1:]).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tc.rms_norm(_t(x), _t(g)).numpy(),
        np.asarray(jc.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        rtol=1e-6, atol=1e-6)


def test_rms_norm_bf16_rounding_order():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    g = rng.normal(size=(64,)).astype(np.float32) * 0.1
    got = tc.rms_norm(_t(x).bfloat16(), _t(g).bfloat16())
    want = jc.rms_norm(jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "tanh"])
def test_act_fn(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    np.testing.assert_allclose(
        tc.act_fn(name)(_t(x)).numpy(),
        np.asarray(jc.act_fn(name)(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("head_dim,fraction,theta", [
    (16, 1.0, 1e6), (64, 0.5, 1e4), (32, 1.0, 1e4)])
def test_rope(head_dim, fraction, theta):
    """rope_angles and apply_rope, partial rotary (rope_fraction 0.5)
    included; interleaved pairs, not split halves."""
    rng = np.random.default_rng(head_dim)
    rot = int(head_dim * fraction)
    pos = np.arange(12, dtype=np.int32)[None, :]
    js, jcos = jc.rope_angles(jnp.asarray(pos), head_dim, theta, rot)
    ts, tcos = tc.rope_angles(_t(pos), head_dim, theta, rot)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    x = rng.normal(size=(2, 12, 3, head_dim)).astype(np.float32)
    np.testing.assert_allclose(
        tc.apply_rope(_t(x), ts, tcos).numpy(),
        np.asarray(jc.apply_rope(jnp.asarray(x), js, jcos)),
        rtol=1e-6, atol=1e-6)
    if fraction < 1.0:      # the unrotated half passes through
        out = tc.apply_rope(_t(x), ts, tcos)
        assert torch.equal(out[..., rot:], _t(x)[..., rot:])


# -- the model -------------------------------------------------------------

def _carried(name, dtype="float32", backend="xla", seed=0, full=False,
             **changes):
    """(JAX cfg, JAX params, port cfg, port model) from one seed: the
    smoke config, or the full one (``full``), with ``changes``."""
    def cfg_of(arch):
        return arch.cfg if full else arch.smoke_cfg
    jcfg = dataclasses.replace(cfg_of(jax_arch(name)), dtype=dtype,
                               attn_backend=backend, **changes)
    tcfg = dataclasses.replace(cfg_of(get_arch(name)), dtype=dtype,
                               **changes)
    params = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = T.Transformer(tcfg, T.params_from_numpy(tree, tcfg, "cpu"),
                          device="cpu")
    return jcfg, params, tcfg, model


def _run_both(name, dtype="float32", backend="xla", prompt_len=13,
              cap=None, steps=4, batch=3, **config):
    """Prefill + ``steps`` greedy decode steps on each side; each side
    feeds back its own argmax. Returns per-step (jax logits, port
    logits, jax tokens, port tokens). ``config`` goes to ``_carried``."""
    jcfg, params, tcfg, model = _carried(name, dtype, backend, **config)
    cap = prompt_len + steps if cap is None else cap
    prompts = np.random.default_rng(5).integers(
        0, tcfg.vocab, size=(batch, prompt_len)).astype(np.int32)
    prefill = jax.jit(lambda p, t: JT.prefill(p, jcfg, t))
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jl, jcache = prefill(params, jnp.asarray(prompts))
    pad = cap - prompt_len
    jcache = jcache._replace(
        k=jnp.pad(jcache.k, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))),
        v=jnp.pad(jcache.v, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))))
    tl, tcache = model.prefill(_t(prompts), capacity=cap)
    out = []
    for step in range(steps + 1):
        jtok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        ttok = torch.argmax(tl, -1).to(torch.int32)
        out.append((np.asarray(jl, np.float32), tl.float().numpy(), jtok,
                    ttok.numpy()))
        if step == steps:
            break
        jl, jcache = decode(params, jnp.asarray(jtok)[:, None], jcache)
        tl, tcache = model.decode_step(ttok[:, None], tcache)
    assert tcache.length.tolist() == [prompt_len + steps] * batch
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tcache.k.float().numpy(),
                               np.asarray(jcache.k, np.float32),
                               rtol=tol, atol=tol)
    return out


@pytest.mark.parametrize("name", SMOKE_ARCHS + MOE_ARCHS)
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_prefill_decode_match_jax(name, backend):
    # interpret: the Pallas kernels need block multiples (prompt 16,
    # cache 32); xla: a prompt and a capacity of no special length
    kw = (dict(prompt_len=16, cap=32) if backend == "interpret"
          else dict(prompt_len=13))
    for jl, tl, jtok, ttok in _run_both(name, backend=backend, **kw):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ttok, jtok)


def test_prefill_decode_match_jax_bf16():
    """bfloat16: within 2e-2 of the logits' scale (the largest |logit|,
    about 50 with these random weights) and the same greedy tokens.
    Elementwise 2e-2 does not hold: XLA rounds fused bfloat16 chains
    (silu * up, the residual adds) at other places than eager torch, and
    the logits differ by up to one bfloat16 ulp of the largest one."""
    for jl, tl, jtok, ttok in _run_both("qwen3-1.7b", dtype="bfloat16"):
        scale = np.abs(jl).max()
        assert np.abs(tl - jl).max() <= 2e-2 * scale
        np.testing.assert_array_equal(ttok, jtok)


def test_granite_1b_full_width_one_layer_matches_jax():
    """granite-moe-1b-a400m at its real widths (d 1024, GQA 16:8 of head
    dim 64, 32 experts of 512, the vocab padded 49155 -> 49280) with one
    layer in float32: 2 x 16 prompt tokens (32 groups of one token),
    prefill and 2 decode steps (8 groups of one)."""
    out = _run_both("granite-moe-1b-a400m", prompt_len=16, steps=2,
                    batch=2, full=True, n_layers=1)
    for jl, tl, jtok, ttok in out:
        assert tl.shape == (2, 49280)
        np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ttok, jtok)


@pytest.mark.parametrize("name", SMOKE_ARCHS + MOE_ARCHS)
def test_forward_matches_jax(name):
    jcfg, params, tcfg, model = _carried(name)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(2, 9)).astype(np.int32)
    want, _ = JT.forward(params, jcfg, jnp.asarray(tokens))
    np.testing.assert_allclose(model(_t(tokens)).numpy(),
                               np.asarray(want), rtol=1e-4, atol=1e-4)


def test_forward_logit_softcap_and_padded_vocab():
    """A padded vocab (200 -> 256 rows, masked to -1e30) and gemma's
    soft cap, on the qwen3 smoke shape."""
    jcfg = dataclasses.replace(jax_arch("qwen3-1.7b").smoke_cfg, vocab=200,
                               logit_softcap=30.0)
    tcfg = dataclasses.replace(get_arch("qwen3-1.7b").smoke_cfg, vocab=200,
                               logit_softcap=30.0)
    params = JT.init_params(jax.random.PRNGKey(3), jcfg)
    model = T.Transformer(tcfg, T.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"), device="cpu")
    tokens = np.arange(10, dtype=np.int32)[None, :]
    want, _ = JT.forward(params, jcfg, jnp.asarray(tokens))
    got = model(_t(tokens))
    assert got.shape == (1, 10, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_scatter_kv_drops_a_write_past_the_capacity():
    """The reference's one-hot add drops pos == S; so does the port."""
    cache = torch.zeros((2, 1, 4, 3))
    new = torch.ones((2, 1, 3))
    T._scatter_kv(cache, new, torch.tensor([4, 1], dtype=torch.int32))
    want = JT._scatter_kv(jnp.zeros((2, 1, 4, 3)), jnp.ones((2, 1, 1, 3)),
                          jnp.asarray([4, 1], jnp.int32))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(want))
    assert cache[0].sum() == 0 and cache[1, 0, 1].sum() == 3


def test_params_from_numpy_takes_bf16_without_ml_dtypes_names():
    jcfg = dataclasses.replace(jax_arch("gemma-7b").smoke_cfg,
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch("gemma-7b").smoke_cfg,
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(0), jcfg))
    got = T.params_from_numpy(tree, tcfg, "cpu")
    assert got["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["layers"]["wq"].float().numpy(),
        tree["layers"]["wq"].astype(np.float32))


@pytest.mark.parametrize("name", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_init_params_shapes_and_scales(name):
    """The reference's tree, shapes and scales, from a torch.Generator
    (granite's MoE weights stacked under layers["moe"])."""
    cfg = get_arch(name).smoke_cfg
    jcfg = jax_arch(name).smoke_cfg
    got = T.init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.tree.map(np.asarray,
                        JT.init_params(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got))
    flat_t = jax.tree.leaves(got)
    flat_j = jax.tree.leaves(want)
    for t, j in zip(flat_t, flat_j):
        assert tuple(t.shape) == j.shape
        assert abs(float(t.float().std()) - float(j.std())) <= (
            0.1 * float(j.std()) + 1e-9)
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_param_counts_match_the_reference(name):
    """Both full configs: param_count and active_param_count as the
    reference's, moe_groups 32, and the smoke tree carried across by
    params_from_numpy, the MoE subtree included, value for value."""
    cfg, jcfg = get_arch(name).cfg, jax_arch(name).cfg
    assert cfg.moe_groups == jcfg.moe_groups == 32
    assert tuple(cfg.moe) == tuple(jcfg.moe)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    scfg = get_arch(name).smoke_cfg
    tree = jax.tree.map(np.asarray, JT.init_params(
        jax.random.PRNGKey(1), jax_arch(name).smoke_cfg))
    got = T.params_from_numpy(tree, scfg, "cpu")
    assert set(got["layers"]["moe"]) == {"router", "w_in", "w_out",
                                         "w_gate"}
    for key, want in tree["layers"]["moe"].items():
        np.testing.assert_array_equal(got["layers"]["moe"][key].numpy(),
                                      want)
    model = T.Transformer(scfg, got, device="cpu")
    assert model.layers[1].moe_weights["w_in"].shape == (4, 64, 32)
    assert sum(p.numel() for p in model.parameters()) == (
        scfg.param_count() + (scfg.vocab_padded - scfg.vocab) * 64)


def test_moe_and_unported_archs_raise():
    """An unknown name raises KeyError; both granites resolve since MoE
    was ported, and the GNN names since the GNNs were."""
    for name in ("gatedgcn", "dimenet", "nequip", "gat-cora"):
        assert get_arch(name).family == "gnn"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    assert get_arch("granite-moe-1b-a400m").cfg.moe.n_experts == 32
