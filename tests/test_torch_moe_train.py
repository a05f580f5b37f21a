"""MoE training in the port against the JAX package on the CPU: the loss,
ce and every gradient leaf of ``Transformer.loss_fn`` for the granite
smoke configs against ``jax.value_and_grad`` of
``repro.models.transformer.loss_fn``, at moe_groups 1, 4 and 32, with
and without remat, and where experts overflow their capacity; one
train_4k step against the reference's jitted step; the dispatch and
combine ``autograd.Function`` pair against autograd of the plain
``index_copy``/``index_select`` form in float64; and the plain attention
backward at head dim 256 against ``jax.vjp`` of the reference's
attention.

Tolerances (float32 smoke configs, the reference's weights carried over
with ``params_from_numpy``): loss and ce to rtol 1e-5, every gradient
leaf to 1e-5 of the leaf's largest value (XLA and torch sum in other
orders: a few units of float32 rounding); after a train step, mu and nu
to 1e-5 of their scale and parameters to 1e-6 absolute (an Adam step
moves a parameter by at most lr). The routing is discrete and must be
equal: a float32 rounding could flip a token's choice only where its
k-th and (k+1)-th probabilities tie to 1e-7, which these seeded inputs
do not reach. The float64 checks hold to 1e-12. The d = 256 attention
backward (float32) holds to 2e-5 of each output's largest value."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.training import optim as JO
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import lm_batch_stream
from repro_torch.kernels import ref
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.training.optim import train_state_init, tree_leaves

GRANITES = ("granite-moe-1b-a400m", "granite-moe-3b-a800m")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close_leaves(got, want, what, rel=1e-5, atol=None):
    got, want = tree_leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, i)
        tol = atol if atol is not None else rel * float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


def _archs(name, **change):
    """(reference arch, port arch), their smoke configs changed alike."""
    ra, pa = jax_arch(name), get_arch(name)
    if change:
        moe_change = change.pop("moe", {})
        ra = dataclasses.replace(ra, smoke_cfg=dataclasses.replace(
            ra.smoke_cfg, moe=ra.smoke_cfg.moe._replace(**moe_change),
            **change))
        pa = dataclasses.replace(pa, smoke_cfg=dataclasses.replace(
            pa.smoke_cfg, moe=pa.smoke_cfg.moe._replace(**moe_change),
            **change))
    return ra, pa


def _batch(cfg, b=4, s=128, step=0):
    batch = next(lm_batch_stream(b, s, cfg.vocab, start_step=step))
    return batch["tokens"], batch["labels"]


@functools.lru_cache(maxsize=None)
def _reference(name, groups, capacity_factor):
    """(loss, ce, gradient tree) of the reference's loss_fn at its smoke
    weights (seed 0), as numpy; remat does not change its numbers."""
    ra, _ = _archs(name, moe_groups=groups,
                   moe={"capacity_factor": capacity_factor})
    cfg = ra.smoke_cfg
    jp = ra.init_smoke(jax.random.PRNGKey(0))
    tokens, labels = _batch(cfg)
    (loss, ce), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, cfg, jnp.asarray(tokens),
                             jnp.asarray(labels)), has_aux=True))(jp)
    return (float(loss), float(ce), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, jp))


def _routed(monkeypatch):
    """Record the kept mask of every MoE layer's routes."""
    kept, routes = [], TM.routes

    def record(*args):
        r = routes(*args)
        kept.append(r.keep)
        return r
    monkeypatch.setattr(TM, "routes", record)
    return kept


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("groups,capacity_factor", [
    (1, 1.25), (4, 1.25), (32, 1.25), (4, 0.5)])
@pytest.mark.parametrize("name", GRANITES)
def test_moe_loss_and_grads_match_reference(name, groups, capacity_factor,
                                            remat, monkeypatch):
    """Loss, ce and every gradient leaf (router, experts, attention,
    norms, embedding) against jax.value_and_grad of the reference's
    loss_fn, whose loss is ce + 0.01 * (the load-balancing losses summed
    over layers). Capacity factor 0.5 (half the even share) overflows
    experts in every group; the other cases overflow where the random
    router is uneven. Each case checks that some assignment dropped."""
    want_loss, want_ce, want_g, tree = _reference(name, groups,
                                                  capacity_factor)
    _, pa = _archs(name, moe_groups=groups, remat=remat,
                   moe={"capacity_factor": capacity_factor})
    cfg = pa.smoke_cfg
    model = T.Transformer(cfg, T.params_from_numpy(tree, cfg, "cpu"),
                          device="cpu", train=True)
    grads = model.grad_tree()
    kept = _routed(monkeypatch)
    tokens, labels = _batch(cfg)
    loss, ce = model.loss_fn(torch.from_numpy(tokens),
                             torch.from_numpy(labels))
    loss.backward()
    loss, ce = float(loss.detach()), float(ce)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(ce, want_ce, rtol=1e-5)
    assert loss != ce                       # the aux loss is in it
    _close_leaves(grads, want_g, "grad")
    # forward, then (remat) the recompute of each layer
    assert len(kept) == cfg.n_layers * (2 if remat else 1)
    assert not all(bool(k.all()) for k in kept), "no assignment dropped"


def test_moe_train_step_matches_reference():
    """Two steps of the port's train_4k step for granite-moe-3b-a800m's
    smoke config at moe_groups 4 with remat, against the reference's
    jitted step on the same weights and batches: loss, ce, gnorm, mu, nu
    and the parameters after each step."""
    ra, pa = _archs("granite-moe-3b-a800m", moe_groups=4, remat=True)
    jp = ra.init_smoke(jax.random.PRNGKey(0))
    cfg = pa.smoke_cfg
    model = T.Transformer(cfg, T.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu"), device="cpu", train=True)
    state = train_state_init(model.param_tree())
    jstate = JO.train_state_init(jp)
    jstep = jax.jit(ra.step_fn("train_4k", smoke=True))
    step = pa.step_fn("train_4k", smoke=True)
    b, s = pa.input_sizes("train_4k", smoke=True)["tokens"]
    for _, batch in zip(range(2), lm_batch_stream(b, s, cfg.vocab)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(batch[k])
                                    for k in ("tokens", "labels")})
        state, m = step(model, state, {k: torch.from_numpy(batch[k])
                                       for k in ("tokens", "labels")})
        for k in ("loss", "ce", "gnorm"):
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        _close_leaves(state.mu, jstate.mu, "mu")
        _close_leaves(state.nu, jstate.nu, "nu")
        _close_leaves(state.params, jstate.params, "params", atol=1e-6)
        assert int(state.step) == int(jstate.step)


def test_model_flops_from_active_parameters():
    """6 N a token with N the active parameters (top-k experts): granite
    1b trains 0.429B of 1.335B, granite 3b 0.883B of 3.299B."""
    for name, active, total in (("granite-moe-1b-a400m", 428658688,
                                 1334628352),
                                ("granite-moe-3b-a800m", 882874368,
                                 3298793472)):
        arch, ra = get_arch(name), jax_arch(name)
        assert arch.cfg.active_param_count() == active
        assert arch.cfg.param_count() == total
        assert arch.model_flops("train_4k") == ra.model_flops("train_4k")
        assert arch.model_flops("train_4k", global_batch=2) == (
            6.0 * active * 4096 * 2)


# -- the dispatch and combine ------------------------------------------------

def _plain_mix(params, x, top_p, top_e, cfg, cap):
    """The mix through autograd of the plain scatter and gather: the
    buffer [E g cap + 1, d] by index_copy (drops to the last row), the
    output's drop row zero, index_select back."""
    t, d = x.shape
    g = top_e.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    slot, keep, gates = TM.dispatch(top_p, top_e, e, cap, x.dtype)
    rows = e * g * cap
    expert = torch.div(slot, cap, rounding_mode="floor")
    group = torch.arange(g)[:, None]
    row = torch.where(keep, slot + (expert * (g - 1) + group) * cap,
                      rows).reshape(t * k)
    xk = x[:, None].expand(t, k, d).reshape(t * k, d)
    buf = x.new_zeros((rows + 1, d)).index_copy(0, row, xk)
    xin = buf[:rows].view(e, g * cap, d)
    h = torch.bmm(xin, params["w_in"])
    if cfg.glu:
        h = torch.nn.functional.silu(torch.bmm(xin, params["w_gate"])) * h
    else:
        h = torch.nn.functional.silu(h)
    out = torch.cat([torch.bmm(h, params["w_out"]).reshape(rows, d),
                     x.new_zeros((1, d))])
    y = out.index_select(0, row) * gates.reshape(t * k, 1)
    return y.view(t, k, d).sum(dim=1)


@pytest.mark.parametrize("t,groups,e,k,cf,glu", [
    (64, 1, 4, 2, 1.25, True), (96, 4, 8, 3, 0.5, True),
    (128, 32, 4, 2, 1.25, False), (50, 5, 6, 6, 0.75, True),
    (33, 3, 5, 1, 0.25, False)])
def test_dispatch_combine_equal_plain_autograd_f64(t, groups, e, k, cf,
                                                   glu):
    """mix's Function pair (gathers both ways, no drop row) against
    autograd of the plain index_copy/index_select form in float64: the
    output and the gradients of x, the gates' probabilities and every
    expert weight to 1e-12, with drops in every case: positive inputs and
    a router column pushed up send every token first to expert 0."""
    cfg = TM.MoEConfig(e, k, 8, cf, "silu", glu)
    gen = torch.Generator().manual_seed(t * e + k)
    params = TM.init_moe(cfg, 16, torch.float64, gen)
    params["router"][:, 0] += 0.5           # skew toward expert 0
    x = torch.randn((t, 16), generator=gen, dtype=torch.float64).abs() + 0.1
    go = torch.randn((t, 16), generator=gen, dtype=torch.float64)
    g, tg, cap = TM.group_plan(t, groups, cfg)
    probs, top_p, top_e = TM.route(params["router"], x.reshape(g, tg, 16),
                                   k)
    assert not bool(TM.dispatch(top_p, top_e, e, cap, x.dtype)[1].all())
    got = []
    for fn in (TM.mix, _plain_mix):
        leaves = {n: w.clone().requires_grad_() for n, w in params.items()
                  if n != "router"}
        xx = x.clone().requires_grad_()
        pp = top_p.detach().clone().requires_grad_()
        y = fn(leaves, xx, pp, top_e, cfg, cap)
        grads = torch.autograd.grad(y, [xx, pp, *leaves.values()], go)
        got.append((y.detach(), *grads))
    for a, b in zip(*got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)


def test_routes_invert_dispatch():
    """routes' two maps are each other's inverse on the kept assignments:
    every kept assignment's row names it back, every filled row is some
    kept assignment's, and the filled rows are as many as the kept."""
    cfg = TM.MoEConfig(8, 3, 8, 0.75)
    gen = torch.Generator().manual_seed(0)
    params = TM.init_moe(cfg, 16, torch.float32, gen)
    x = torch.randn((120, 16), generator=gen)
    g, tg, cap = TM.group_plan(120, 4, cfg)
    _, top_p, top_e = TM.route(params["router"], x.reshape(g, tg, 16), 3)
    r = TM.routes(top_p, top_e, 8, cap, torch.float32)
    n = torch.arange(120 * 3)
    assert torch.equal(r.src[r.row[r.keep]], n[r.keep])
    assert torch.equal(r.row[r.src[r.filled]], torch.nonzero(r.filled)[:, 0])
    assert int(r.filled.sum()) == int(r.keep.sum()) < 360
    slot, keep, _ = TM.dispatch(top_p, top_e, 8, cap, torch.float32)
    assert torch.equal(keep.reshape(-1), r.keep)


def test_aux_loss_gradient_matches_reference_one_hot_form():
    """load_balance (the mean prob of each token's first choice) has the
    gradient of the reference's E sum(top1.mean * probs.mean) in float64."""
    gen = torch.Generator().manual_seed(1)
    probs = torch.softmax(torch.randn((3, 10, 6), generator=gen,
                                      dtype=torch.float64), -1)
    top_e = torch.topk(probs, 2, -1).indices
    a = probs.clone().requires_grad_()
    b = probs.clone().requires_grad_()
    got = TM.load_balance(a, top_e, 6)
    top1 = torch.nn.functional.one_hot(top_e[..., 0], 6).double()
    want = (6 * (top1.mean(1) * b.mean(1)).sum(-1)).mean()
    (ga,), (gb,) = (torch.autograd.grad(got, a),
                    torch.autograd.grad(want, b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=1e-15)


# -- the attention backward at head dim 256 ----------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,s", [(4, 4, 33), (4, 2, 64), (2, 1, 17)])
def test_attention_bwd_ref_d256_matches_reference_vjp(causal, hq, hkv, s):
    """attention_bwd_ref at d = 256 (gemma's head dim), from the forward's
    log-sum-exp, against jax.vjp of the reference's attention_ref in
    float32: dq, dk, dv within 2e-5 of each one's largest value; the
    output within 1e-5."""
    rng = np.random.default_rng(hq * 10 + s)
    q, do = (rng.normal(size=(2, hq, s, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, hkv, s, 256)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.attention_lse_ref(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), rtol=0,
                               atol=1e-5 * float(np.abs(out).max()))
    got = ref.attention_bwd_ref(tq, tk, tv, o, tdo, lse, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * float(np.abs(b).max()),
                                   err_msg=name)
