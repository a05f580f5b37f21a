"""The port's FM recsys path (repro_torch.kernels.fm_interaction on CPU
tensors, repro_torch.models.recsys.fm, the fm config, the recsys id
stream) against the JAX package on the same seeded inputs: the plain
interaction against the reference and the Pallas kernel in interpret
mode, and the model against ``repro.models.recsys.fm`` under both of
its backends ("xla" and "interpret"), with out-of-range and negative
ids so that clipping is exercised.

Tolerances, all float32 with sums taken in another order:
- interaction on N(0, 1) inputs: rtol 2e-4, atol 2e-4, the reference's
  own kernel tests (tests/test_kernels.py); outputs reach about 100
  after cancelling terms of about 400;
- the model (weights from Normal(0, 0.01), logits about 0.1): rtol
  1e-5, atol 1e-6, a few float32 units of the largest term;
- bfloat16 against the interpret kernel: one bfloat16 unit (rtol 1e-2)
  beside the float32 bound (atol 2e-4); both compute in float32 and
  round once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data.synthetic import recsys_stream as jax_recsys_stream
from repro.kernels import ops, ref as jref
from repro.models.recsys import fm as JFM
from repro_torch.configs import get_arch
from repro_torch.training.optim import train_state_init
from repro_torch.data import recsys_stream
from repro_torch.kernels import fm_interaction as FI
from repro_torch.kernels import ref as tref
from repro_torch.models.recsys import fm as TFM

KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = [(32, 39, 10), (1000, 39, 10), (4096, 26, 16), (7, 13, 4)]
# the smoke config, and the full config's 39 fields x k 10 at a small vocab
CONFIGS = {"smoke": JFM.FMConfig(n_fields=8, embed_dim=4, vocab=1000),
           "39x10": JFM.FMConfig(n_fields=39, embed_dim=10, vocab=10_000)}


def _close(got: torch.Tensor, want, tol=MODEL_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _vmapped_interpret(x, v):
    """The reference model's per-example use of the Pallas kernel."""
    return jax.vmap(lambda vb, xb: ops.fm_interaction(
        xb[None, :], vb, backend="interpret")[0])(jnp.asarray(v),
                                                  jnp.asarray(x))


def _model_pair(name, seed=0):
    """(JAX params, JAX cfg, port FM on the CPU with the same weights)."""
    jcfg = CONFIGS[name]
    params = JFM.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = {k: np.asarray(v) for k, v in params.items()}
    tcfg = TFM.FMConfig(jcfg.n_fields, jcfg.embed_dim, jcfg.vocab)
    model = TFM.FM(tcfg, TFM.params_from_numpy(tree, "cpu"), device="cpu")
    return params, jcfg, model


def _ids(rng, shape, vocab):
    """Ids from -5 to vocab + 99: some clip to row 0, some to vocab - 1."""
    return rng.integers(-5, vocab + 100, size=shape).astype(np.int32)


# -- the interaction ------------------------------------------------------

@pytest.mark.parametrize("b,f,k", SHAPES)
def test_fm_interaction_plain_matches_jax(b, f, k):
    rng = np.random.default_rng(b + f + k)
    x = rng.normal(size=(b, f)).astype(np.float32)
    v = rng.normal(size=(f, k)).astype(np.float32)
    got = FI.fm_interaction(torch.from_numpy(x), torch.from_numpy(v))
    assert got.shape == (b,) and got.dtype == torch.float32
    _close(got, jref.fm_interaction_ref(jnp.asarray(x), jnp.asarray(v)),
           KERNEL_TOL)
    _close(got, ops.fm_interaction(jnp.asarray(x), jnp.asarray(v),
                                   backend="interpret", batch_block=256),
           KERNEL_TOL)
    torch.testing.assert_close(
        got, tref.fm_interaction_ref(torch.from_numpy(x), torch.from_numpy(v)))


@pytest.mark.parametrize("b,f,k", [(32, 39, 10), (7, 13, 4)])
def test_fm_interaction_bfloat16_matches_interpret_kernel(b, f, k):
    """bf16 inputs rounded from the same float32 draws on both sides."""
    rng = np.random.default_rng(b * f)
    x = rng.normal(size=(b, f)).astype(np.float32)
    v = rng.normal(size=(f, k)).astype(np.float32)
    got = FI.fm_interaction(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(v).bfloat16())
    assert got.dtype == torch.bfloat16
    want = ops.fm_interaction(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(v, jnp.bfloat16),
                              backend="interpret", batch_block=8)
    _close(got, want.astype(jnp.float32), dict(rtol=1e-2, atol=2e-4))


def test_fm_interaction_matches_bruteforce():
    """sum over field pairs i < j of <v_i, v_j> x_i x_j, in float64, for
    a shared v and for one v per row."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    v = rng.normal(size=(4, 6, 3)).astype(np.float32)
    shared = np.zeros(4)
    per_row = np.zeros(4)
    for i in range(6):
        for j in range(i + 1, 6):
            shared += (v[0, i] @ v[0, j]) * x[:, i] * x[:, j]
            per_row += (v[:, i] * v[:, j]).sum(-1) * x[:, i] * x[:, j]
    tx = torch.from_numpy(x)
    _close(FI.fm_interaction(tx, torch.from_numpy(v[0])), shared,
           dict(rtol=1e-4, atol=1e-5))
    _close(FI.fm_interaction(tx, torch.from_numpy(v)), per_row,
           dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("b,f,k", [(32, 39, 10), (7, 13, 4)])
@pytest.mark.parametrize("ones", [False, True])
def test_fm_interaction_per_row_matches_vmapped_kernel(b, f, k, ones):
    """v [b, f, k] against jax.vmap of the interpret kernel; with
    ``ones``, x is all ones (the model's use) and broadcast by stride 0
    on the port's side."""
    rng = np.random.default_rng(f * k)
    x = (np.ones((b, f), np.float32) if ones
         else rng.normal(size=(b, f)).astype(np.float32))
    v = rng.normal(size=(b, f, k)).astype(np.float32)
    tx = (torch.ones((1, 1)).expand(b, f) if ones else torch.from_numpy(x))
    got = FI.fm_interaction(tx, torch.from_numpy(v))
    _close(got, _vmapped_interpret(x, v), KERNEL_TOL)
    # a v broadcast over rows by stride 0 is the shared form
    tv = torch.from_numpy(v[0])
    torch.testing.assert_close(FI.fm_interaction(tx, tv[None].expand(b, f, k)),
                               FI.fm_interaction(tx, tv))


# -- the model ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_forward_matches_jax(name, backend):
    params, jcfg, model = _model_pair(name)
    ids = _ids(np.random.default_rng(1), (32, jcfg.n_fields), jcfg.vocab)
    want = JFM.forward(params, jcfg._replace(backend=backend),
                       jnp.asarray(ids))
    got = model(torch.from_numpy(ids))
    assert got.shape == (32,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_retrieval_scores_match_jax(name):
    params, jcfg, model = _model_pair(name, seed=2)
    rng = np.random.default_rng(2)
    ctx = _ids(rng, (jcfg.n_fields,), jcfg.vocab)
    cand = _ids(rng, (1024,), jcfg.vocab)
    want = JFM.retrieval_scores(params, jcfg, jnp.asarray(ctx),
                                jnp.asarray(cand))
    _close(model.retrieval_scores(torch.from_numpy(ctx),
                                  torch.from_numpy(cand)), want)


def _bags(rng, n_bags, vocab):
    """Sorted bag ids of bags of 0 to 8 ids (every 5th bag empty) and the
    ids, some out of range."""
    sizes = rng.integers(1, 9, n_bags)
    sizes[::5] = 0
    bag_ids = np.repeat(np.arange(n_bags), sizes).astype(np.int32)
    return _ids(rng, bag_ids.shape, vocab), bag_ids


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("backend", ["xla", "interpret"])
def test_embedding_bag_matches_jax(mode, backend):
    rng = np.random.default_rng(3)
    table = rng.normal(size=(500, 10)).astype(np.float32)
    ids, bag_ids = _bags(rng, 60, 500)
    want = JFM.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(bag_ids), 60, mode, backend)
    got = TFM.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(bag_ids), 60, mode)
    assert got.shape == (60, 10)
    assert not got[::5].any()
    _close(got, want)


def test_loss_fn_matches_jax():
    params, jcfg, model = _model_pair("39x10", seed=4)
    batch = next(recsys_stream(64, jcfg.n_fields, jcfg.vocab, seed=4))
    want = JFM.loss_fn(params, jcfg, jnp.asarray(batch["ids"]),
                       jnp.asarray(batch["labels"]))
    got = model.loss_fn(torch.from_numpy(batch["ids"]),
                        torch.from_numpy(batch["labels"]))
    _close(got, want)


def test_recsys_stream_matches_reference():
    ours, theirs = (recsys_stream(16, 39, 4_000_000, start_step=3, seed=5),
                    jax_recsys_stream(16, 39, 4_000_000, start_step=3, seed=5))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a["step"] == b["step"]
        for key in ("ids", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# -- the config and its step functions ----------------------------------------

def test_recsys_arch_matches_reference():
    arch, ref_arch = get_arch("fm"), jax_arch("fm")
    assert type(arch).__name__ == "RecsysArch"
    for cfg, rcfg in ((arch.cfg, ref_arch.cfg),
                      (arch.smoke_cfg, ref_arch.smoke_cfg)):
        assert tuple(cfg) == tuple(rcfg)[:3]
    assert sorted(arch.shapes) == sorted(ref_arch.shapes)
    for name, shape in arch.shapes.items():
        ref_shape = ref_arch.shapes[name]
        assert (shape.kind, shape.sizes) == (ref_shape.kind, ref_shape.sizes)
        for smoke in (False, True):
            specs = ref_arch.input_specs(name, smoke=smoke)
            assert all(s.dtype == jnp.int32 for s in specs.values())
            assert arch.input_sizes(name, smoke=smoke) == {
                k: tuple(s.shape) for k, s in specs.items()}


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_step_fns_match_reference(shape):
    arch, ref_arch = get_arch("fm"), jax_arch("fm")
    params = ref_arch.init_smoke(jax.random.PRNGKey(6))
    model = TFM.FM(arch.smoke_cfg, TFM.params_from_numpy(
        {k: np.asarray(v) for k, v in params.items()}, "cpu"), device="cpu")
    rng = np.random.default_rng(6)
    batch = {k: _ids(rng, size, arch.smoke_cfg.vocab)
             for k, size in arch.input_sizes(shape, smoke=True).items()}
    want = ref_arch.step_fn(shape, smoke=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = arch.step_fn(shape, smoke=True)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want)
    with pytest.raises(ValueError, match="config"):
        arch.step_fn(shape)(model, batch)        # made for the full config


def test_train_step_not_ported():
    """FM training is ported (tests/test_torch_train.py holds it to the
    reference); what its train step refuses is a serving model, whose
    parameters are frozen."""
    arch = get_arch("fm")
    step = arch.step_fn("train_batch", smoke=True)
    model = TFM.FM(arch.smoke_cfg, device="cpu")
    batch = {"ids": torch.zeros((4, arch.smoke_cfg.n_fields),
                                dtype=torch.int32),
             "labels": torch.zeros((4,), dtype=torch.int32)}
    with pytest.raises(ValueError, match="train=True"):
        step(model, train_state_init(model.param_tree()), batch)


def test_fm_refuses_cpu_fallback(monkeypatch):
    """FM defaults to the card and raises without one; it runs on the
    CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("fm").smoke_cfg
    with pytest.raises(RuntimeError, match="CUDA"):
        TFM.FM(cfg)
    model = TFM.FM(cfg, device="cpu")
    assert model.device.type == "cpu"
    assert not any(p.requires_grad for p in model.parameters())
    assert model.v.shape == (cfg.vocab, cfg.embed_dim)
