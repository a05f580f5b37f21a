"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's
(repro.models.moe) on the CPU, with the reference's weights carried
over.

float32: y within 1e-5, aux within 1e-6, and the routing (top_e), the
slots and keep equal exactly, over token counts that are prime, smaller
than the group count or a multiple of it, groups 1, 4 and 32, top-1 to
top-all, GLU on and off, and capacities that force drops (capacity
factor 0.5, and a router column that sends every token to expert 0).
bfloat16, on identical bfloat16 inputs: the routing and slots equal (the
router is float32 in both) and y within 2e-2 of its scale.

Routing is discrete: a logit difference of one float32 rounding flips a
token's choice only where its k-th and (k+1)-th probabilities nearly
tie. Where a choice differs, the failure names the token and its
float64 margin p_(k) - p_(k+1); the inputs are not re-seeded to avoid
one."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tier-1 run has several xdist workers on a shared host; torch's
    idle OpenMP threads spin there and make many small ops slow."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


D, FF = 32, 16


def _plan(t, groups, cfg):
    """g and cap as the reference computes them (moe.py:69-71)."""
    g = max(v for v in range(1, min(groups, t) + 1) if t % v == 0)
    tg = t // g
    return g, tg, int(max(1, (tg * cfg.top_k * cfg.capacity_factor)
                          // cfg.n_experts))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _reference(params, x, cfg, groups):
    """The reference's moe_ffn, and its group-local slots, gates, top-k
    experts and probabilities (its _route_and_scatter, vmapped)."""
    y, aux = JM.moe_ffn(params, x, cfg, groups=groups)
    t, d = x.shape
    g, tg, cap = _plan(t, groups, cfg)
    xg = x.reshape(g, tg, d)
    _, slot, gates, _ = jax.vmap(
        lambda xx: JM._route_and_scatter(params, xx, cfg, cap))(xg)
    probs = jax.nn.softmax(
        xg.astype(jnp.float32) @ params["router"].astype(jnp.float32), -1)
    _, top_e = jax.lax.top_k(probs, cfg.top_k)
    return y, aux, slot, gates, top_e


def _inputs(t, e, k, glu, cf, overflow, dtype, seed):
    jcfg = JM.MoEConfig(e, k, FF, cf, "silu", glu)
    tcfg = TM.MoEConfig(e, k, FF, cf, "silu", glu)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = JM.init_moe(jax.random.PRNGKey(seed), jcfg, D, jdt)
    x = np.random.default_rng(seed).normal(size=(t, D)).astype(np.float32)
    if overflow:
        # positive inputs and a large positive router column: every
        # token's first choice is expert 0, which overflows every group
        # that holds more tokens than its capacity
        x = np.abs(x) + 0.5
        r = np.array(params["router"], np.float32)
        r[:, 0] = 4.0 * np.abs(r[:, 0]) + 0.5
        params = dict(params, router=jnp.asarray(r, jdt))
    x = jnp.asarray(x, jdt)
    return jcfg, tcfg, params, x


def _torch_tree(params):
    """The reference's arrays as tensors (bfloat16 by its 2-byte
    payload)."""
    from repro_torch.models.transformer import _tensor_from_numpy

    def conv(a):
        a = np.asarray(a)
        dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
        return _tensor_from_numpy(a, dt, "cpu")
    return {k: conv(v) for k, v in params.items()}


def _margins(params, x, k):
    """float64 p_(k) - p_(k+1) of each token (inf when k = E)."""
    r = np.asarray(jnp.asarray(params["router"], jnp.float32), np.float64)
    logits = np.asarray(jnp.asarray(x, jnp.float32), np.float64) @ r
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)
    return (p[:, k - 1] - p[:, k]) if k < r.shape[1] else np.full(
        len(p), np.inf)


def _run(t, groups, e, k, glu, cf, overflow=False, dtype="float32",
         seed=0):
    jcfg, tcfg, params, x = _inputs(t, e, k, glu, cf, overflow, dtype,
                                    seed)
    want = [np.asarray(a) for a in _reference(params, x, jcfg, groups)]
    tp = _torch_tree(params)
    tx = _torch_tree({"x": x})["x"]
    g, tg, cap = TM.group_plan(t, groups, tcfg)
    assert (g, tg, cap) == _plan(t, groups, jcfg)
    y, aux = TM.moe_ffn(tp, tx, tcfg, groups=groups)
    assert y.dtype == tx.dtype and y.shape == (t, D)
    _, top_p, top_e = TM.route(tp["router"], tx.reshape(g, tg, D), k)
    slot, keep, gates = TM.dispatch(top_p, top_e, e, cap, tx.dtype)
    differ = np.nonzero((top_e.numpy() != want[4]).any(-1).reshape(-1))[0]
    margins = _margins(params, x, k)
    assert not len(differ), (
        f"routing differs at tokens {differ.tolist()} with float64 margins "
        f"{margins[differ].tolist()}")
    np.testing.assert_array_equal(slot.numpy(), want[2])
    np.testing.assert_array_equal(keep.numpy(), want[2] < e * cap)
    return dict(y=y.float().numpy(), aux=float(aux),
                gates=gates.float().numpy(), keep=keep.numpy(),
                want_y=want[0].astype(np.float32), want_aux=float(want[1]),
                want_gates=want[3].astype(np.float32), g=g, tg=tg, cap=cap)


EXPERTS = [(4, 2, True, 1.25), (8, 1, False, 1.25), (8, 8, True, 1.25),
           (4, 2, False, 0.5), (8, 1, True, 0.5)]


# (t, groups) -> g groups of tg tokens: 1 x 1 (t < groups), 1 x 7 (t
# prime: 4's largest divisor is 1), 7 x 1 (t prime and < groups), 1 x
# 64, 32 x 2, 4 x 24, 32 x 3
TOKENS = [(1, 32), (7, 4), (7, 32), (64, 1), (64, 32), (96, 4), (96, 32)]


@pytest.mark.parametrize("e,k,glu,cf", EXPERTS)
@pytest.mark.parametrize("t,groups", TOKENS)
def test_moe_ffn_matches_reference_f32(t, groups, e, k, glu, cf):
    r = _run(t, groups, e, k, glu, cf)
    np.testing.assert_allclose(r["y"], r["want_y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["aux"], r["want_aux"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(r["gates"], r["want_gates"], rtol=1e-6,
                               atol=1e-7)
    if e * r["cap"] < r["tg"] * k:      # more assignments than room
        assert not r["keep"].all()


@pytest.mark.parametrize("e,k,glu", [(4, 2, True), (8, 1, False),
                                     (8, 8, True)])
@pytest.mark.parametrize("t,groups", [(64, 1), (96, 4), (64, 32)])
def test_moe_ffn_one_expert_overflows(t, groups, e, k, glu):
    """Every token's first choice is expert 0: each group of more tokens
    than the capacity drops some of them, and the port drops the same
    ones."""
    r = _run(t, groups, e, k, glu, 1.25, overflow=True)
    np.testing.assert_allclose(r["y"], r["want_y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r["aux"], r["want_aux"], rtol=1e-6,
                               atol=1e-6)
    if r["tg"] > r["cap"]:
        assert not r["keep"].all()
        dropped = (~r["keep"]).reshape(r["g"], r["tg"], k)
        assert (dropped[..., 0].sum(-1) == r["tg"] - r["cap"]).all()


@pytest.mark.parametrize("t,groups,e,k", [(96, 4, 8, 2), (64, 32, 8, 8),
                                          (96, 1, 4, 2), (7, 32, 8, 1)])
def test_moe_ffn_bf16_on_identical_inputs(t, groups, e, k):
    r = _run(t, groups, e, k, True, 1.25, dtype="bfloat16", seed=3)
    scale = np.abs(r["want_y"]).max()
    assert np.abs(r["y"] - r["want_y"]).max() <= 2e-2 * scale
    np.testing.assert_allclose(r["aux"], r["want_aux"], rtol=1e-6,
                               atol=1e-6)


def test_moe_ffn_float64_and_the_drop_row():
    """float64 inputs stay float64; a dropped assignment reads the zero
    row: with capacity forced to 1 and one expert, y is each group's
    first token's expert output and 0 for the rest."""
    cfg = TM.MoEConfig(n_experts=1, top_k=1, d_ff=8, capacity_factor=0.01)
    gen = torch.Generator().manual_seed(0)
    p = TM.init_moe(cfg, 16, torch.float64, gen)
    x = torch.randn((12, 16), generator=gen, dtype=torch.float64)
    y, aux = TM.moe_ffn(p, x, cfg, groups=3)
    assert y.dtype == torch.float64 and float(aux) == 1.0
    assert TM.group_plan(12, 3, cfg) == (3, 4, 1)
    first = x[::4]
    want = (torch.nn.functional.silu(first @ p["w_gate"][0])
            * (first @ p["w_in"][0])) @ p["w_out"][0]
    torch.testing.assert_close(y[::4], want)
    assert not y.reshape(3, 4, 16)[:, 1:].any()

