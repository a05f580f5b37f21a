"""The port's serving entry point (repro_torch.launch.serve) against
the JAX package's serve loop, replayed here (repro/launch/serve.py,
prefill, the cache padded to prompt_len + gen_tokens, greedy decode),
with the reference's weights carried over: the greedy tokens must be
identical (float32 smoke configs, dense and MoE)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as T


def _jax_serve_tokens(params, cfg, prompts, gen_tokens):
    """The reference's serve loop (serve.py:50-78), without its timers."""
    cap = prompts.shape[1] + gen_tokens
    prefill = jax.jit(lambda p, t: JT.prefill(p, cfg, t))
    decode = jax.jit(lambda p, tok, cache: JT.decode_step(p, cfg, tok,
                                                          cache))
    logits, cache = prefill(params, jnp.asarray(prompts, jnp.int32))
    pad = cap - prompts.shape[1]
    cache = cache._replace(
        k=jnp.pad(cache.k, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))),
        v=jnp.pad(cache.v, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))))
    generated = []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(gen_tokens):
        generated.append(np.asarray(tok)[:, 0])
        logits, cache = decode(params, tok, cache)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return np.stack(generated, axis=1), np.asarray(logits), cache


@pytest.mark.parametrize("name", ["qwen3-1.7b", "chatglm3-6b", "gemma-7b",
                                  "granite-moe-3b-a800m",
                                  "granite-moe-1b-a400m"])
def test_generate_matches_the_jax_serve_loop(name):
    jcfg = jax_arch(name).smoke_cfg
    tcfg = get_arch(name).smoke_cfg
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.Transformer(tcfg, T.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"), device="cpu")
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab, size=(4, 11))
    want, want_logits, want_cache = _jax_serve_tokens(params, jcfg, prompts,
                                                      6)
    g = serve.generate(model, prompts, 6)
    np.testing.assert_array_equal(g.tokens, want)
    np.testing.assert_allclose(g.logits.numpy(), want_logits, rtol=1e-4,
                               atol=1e-4)
    assert g.cache.k.shape == want_cache.k.shape == (2, 4, tcfg.n_kv_heads,
                                                     17, tcfg.hd)
    assert g.cache.length.tolist() == [17] * 4
    steps = g.registry.percentiles("serve.decode_step_s")
    assert steps["count"] == 6
    assert g.registry.get_gauge("serve.prefill_s") == g.prefill_s > 0


@pytest.mark.parametrize("name", ["qwen3-1.7b", "granite-moe-1b-a400m"])
def test_main_smoke_on_cpu_prints_the_reference_dict(capsys, name):
    out = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                      "--requests", "2", "--prompt-len", "5",
                      "--gen-tokens", "3", "--seed", "4"])
    assert set(out) == {"requests", "prefill_s", "decode_s",
                        "decode_step_p50_ms", "decode_step_p99_ms",
                        "tokens_per_s", "sample_output"}
    assert out["requests"] == 2 and len(out["sample_output"]) == 3
    assert str(out) in capsys.readouterr().out
    again = serve.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--requests", "2", "--prompt-len", "5",
                        "--gen-tokens", "3", "--seed", "4"])
    assert again["sample_output"] == out["sample_output"]   # from --seed


def test_generate_zero_tokens_and_bf16():
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").smoke_cfg,
                              dtype="bfloat16")
    model = T.Transformer(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    prompts = np.zeros((2, 4), np.int64)
    g = serve.generate(model, prompts, 0)
    assert g.tokens.shape == (2, 0) and g.cache.length.tolist() == [4, 4]
    g = serve.generate(model, prompts, 3)
    assert g.tokens.shape == (2, 3) and (g.tokens < cfg.vocab).all()
    assert torch.isfinite(g.logits.float()).all()
