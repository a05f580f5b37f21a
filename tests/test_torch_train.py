"""The port's training path against the JAX package's on the CPU: the LM
train step (cross-entropy, AdamW, remat) on the smoke configs of
qwen3-1.7b, chatglm3-6b and gemma-7b (partial rotary, untied
unembedding, GELU, the sqrt(d) embedding scale, a soft-capped variant),
the FM train step, the token stream, the training launcher's checkpoints
and resume (either package's checkpoint restores in the port), and the
backward plain versions against autograd.

Tolerances (float32 smoke configs, the reference's weights carried over):
loss, ce and gnorm to rtol 1e-5; every gradient leaf, mu and nu to 1e-5
of the leaf's largest value; parameters to 1e-6 absolute (they are
O(0.1 to 1)). XLA and torch sum in other orders, so two float32 runs of
the same step differ by a few units of float32 rounding (measured: 1e-6
of scale and below), and an Adam step moves a parameter by at most lr
(3e-6 to 9e-6 over these steps) whatever the gradient's size, so no
parameter can drift further than that either."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import synthetic as JS
from repro.launch import train as jax_train
from repro.models import common as jc
from repro.models import transformer as JT
from repro.training import optim as JO
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import get_arch
from repro_torch.data.synthetic import lm_batch_stream
from repro_torch.engine.faults import (
    FaultPlan, FaultSpec, SimulatedCrash, install,
)
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fm_interaction as FI
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.models import common as tc
from repro_torch.models import transformer as T
from repro_torch.models.recsys import fm as TFM
from repro_torch.training.optim import train_state_init, tree_leaves


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


# -- data and loss -----------------------------------------------------------

@pytest.mark.parametrize("batch,seq,vocab,start", [
    (4, 128, 256, 0), (2, 4096, 151936, 7), (3, 33, 49155, 100)])
def test_lm_batch_stream_byte_equal(batch, seq, vocab, start):
    ours = lm_batch_stream(batch, seq, vocab, start_step=start)
    theirs = JS.lm_batch_stream(batch, seq, vocab, start_step=start)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a["step"] == b["step"]
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_cross_entropy_loss():
    """float32 logsumexp, clipped label gather, ignore_id masked mean; all
    positions ignored gives 0."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 0] = 40                       # clipped into [0, V - 1]
    for lg, lb in ((logits, labels), (logits, np.full((3, 5), -1, np.int32))):
        want = jc.cross_entropy_loss(jnp.asarray(lg), jnp.asarray(lb))
        got = tc.cross_entropy_loss(torch.from_numpy(lg),
                                    torch.from_numpy(lb))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)
    bf = torch.from_numpy(logits).bfloat16()
    want = jc.cross_entropy_loss(jnp.asarray(_np(bf)).astype(jnp.bfloat16),
                                 jnp.asarray(labels))
    np.testing.assert_allclose(
        tc.cross_entropy_loss(bf, torch.from_numpy(labels)).numpy(),
        np.asarray(want), rtol=1e-6)


# -- the LM train step ------------------------------------------------------

LM_CASES = {
    "qwen3-1.7b": {}, "chatglm3-6b": {}, "gemma-7b": {},
    "gemma-7b-softcap": {"logit_softcap": 30.0},
}


def _archs(case):
    name = case.replace("-softcap", "")
    ra, pa = jax_arch(name), get_arch(name)
    change = LM_CASES[case]
    if change:
        ra = dataclasses.replace(
            ra, smoke_cfg=dataclasses.replace(ra.smoke_cfg, **change))
        pa = dataclasses.replace(
            pa, smoke_cfg=dataclasses.replace(pa.smoke_cfg, **change))
    return ra, pa


def _lm_model(ra, pa, cfg=None):
    cfg = cfg or pa.smoke_cfg
    jp = ra.init_smoke(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    model = T.Transformer(cfg, T.params_from_numpy(tree, cfg, "cpu"),
                          device="cpu", train=True)
    return jp, model


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_train_step_matches_reference(case):
    """Three steps of the port's train_4k step against the reference's
    jitted one on the same weights and batches: loss, ce, gnorm, every
    gradient leaf (against jax.grad of the reference's loss at the same
    parameters), params, mu and nu after each step."""
    ra, pa = _archs(case)
    jp, model = _lm_model(ra, pa)
    state = train_state_init(model.param_tree())
    jstate = JO.train_state_init(jp)
    jstep = jax.jit(ra.step_fn("train_4k", smoke=True))
    step = pa.step_fn("train_4k", smoke=True)
    b, s = pa.input_sizes("train_4k", smoke=True)["tokens"]
    cfg = ra.smoke_cfg
    for _, batch in zip(range(3), lm_batch_stream(b, s, cfg.vocab)):
        jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
        _, jg = jax.value_and_grad(
            lambda p: JT.loss_fn(p, cfg, jb["tokens"], jb["labels"]),
            has_aux=True)(jstate.params)
        jstate, jm = jstep(jstate, jb)
        state, m = step(model, state, {k: torch.from_numpy(batch[k])
                                       for k in ("tokens", "labels")})
        assert set(m) == {"loss", "ce", "gnorm"}
        for k in m:
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        _close_leaves(model.grads, jg, "grad")
        _close_leaves(state.mu, jstate.mu, "mu")
        _close_leaves(state.nu, jstate.nu, "nu")
        _close_leaves(state.params, jstate.params, "params", atol=1e-6)
        assert int(state.step) == int(jstate.step)
        assert state.params is model.param_tree()


def test_lm_float32_loss_and_grads_at_a_kernel_head_dim():
    """qwen3-1.7b's config in float32 cut to 1 layer, d_model 256, 2
    heads of 128 over 1 KV head (a head dim and a GQA group the card's
    float32 attention backward takes), d_ff 512 and vocab 512: the loss,
    ce and every gradient leaf of the port's loss over 64 tokens against
    jax.value_and_grad of the reference's loss at the same weights (the
    module's tolerances)."""
    cut = dict(n_layers=1, d_model=256, n_heads=2, n_kv_heads=1,
               head_dim=128, d_ff=512, vocab=512, dtype="float32")
    ra, pa = jax_arch("qwen3-1.7b"), get_arch("qwen3-1.7b")
    ra = dataclasses.replace(ra, smoke_cfg=dataclasses.replace(ra.cfg,
                                                               **cut))
    pa = dataclasses.replace(pa, smoke_cfg=dataclasses.replace(pa.cfg,
                                                               **cut))
    jp, model = _lm_model(ra, pa)
    batch = next(lm_batch_stream(1, 64, 512))
    (jloss, jce), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, ra.smoke_cfg, jnp.asarray(batch["tokens"]),
                             jnp.asarray(batch["labels"])),
        has_aux=True)(jp)
    grads = model.grad_tree()
    loss, ce = model.loss_fn(torch.from_numpy(batch["tokens"]),
                             torch.from_numpy(batch["labels"]))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5)
    np.testing.assert_allclose(_np(ce), np.asarray(jce), rtol=1e-5)
    _close_leaves(grads, jg, "grad")


def test_remat_equals_no_remat():
    """remat=True (each block under torch.utils.checkpoint) gives the same
    bits as remat=False: loss, every gradient leaf and the state."""
    ra, pa = _archs("qwen3-1.7b")
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(pa.smoke_cfg, remat=remat)
        arch = dataclasses.replace(pa, smoke_cfg=cfg)
        _, model = _lm_model(ra, arch, cfg)
        state = train_state_init(model.param_tree())
        step = arch.step_fn("train_4k", smoke=True)
        for _, batch in zip(range(2), lm_batch_stream(4, 128, cfg.vocab)):
            state, m = step(model, state, {k: torch.from_numpy(batch[k])
                                           for k in ("tokens", "labels")})
        out.append((m, model.grads, state))
    (m0, g0, s0), (m1, g1, s1) = out
    for k in m0:
        assert torch.equal(m0[k], m1[k])
    for a, b in zip(tree_leaves((g0, s0.params, s0.mu, s0.nu)),
                    tree_leaves((g1, s1.params, s1.mu, s1.nu))):
        assert torch.equal(a, b)


def test_param_tree_and_grad_tree_share_the_modules_storage():
    """Block i's parameters are layer i of the stacked tree; grad_tree's
    layer views are their .grad, so backward fills the stacked layout."""
    ra, pa = _archs("chatglm3-6b")
    _, model = _lm_model(ra, pa)
    tree = model.param_tree()
    assert model.layers[1].wq.data_ptr() == tree["layers"]["wq"][1].data_ptr()
    assert model.unembed.data_ptr() == tree["unembed"].data_ptr()
    grads = model.grad_tree()
    assert model.layers[1].w_in.grad.data_ptr() == (
        grads["layers"]["w_in"][1].data_ptr())
    loss, _ = model.loss_fn(torch.zeros((1, 8), dtype=torch.int32),
                            torch.ones((1, 8), dtype=torch.int32))
    loss.backward()
    assert float(grads["layers"]["w_in"][1].abs().sum()) > 0
    assert model.grad_tree() is grads
    assert float(grads["layers"]["w_in"].abs().sum()) == 0   # zeroed


def test_train_step_refusals():
    ra, pa = _archs("qwen3-1.7b")
    jp, model = _lm_model(ra, pa)
    step = pa.step_fn("train_4k", smoke=True)
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    other = train_state_init(T.init_params(
        pa.smoke_cfg, torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="param_tree"):
        step(model, other, batch)
    frozen = T.Transformer(pa.smoke_cfg, model.param_tree(), device="cpu")
    with pytest.raises(ValueError, match="train=True"):
        step(frozen, train_state_init(frozen.param_tree()), batch)
    with pytest.raises(ValueError, match="config"):
        pa.step_fn("train_4k")(model, train_state_init(model.param_tree()),
                               batch)
    with pytest.raises(NotImplementedError, match="serve"):
        pa.step_fn("prefill_32k", smoke=True)


# -- the FM train step -------------------------------------------------------

def test_fm_train_step_matches_reference():
    ra, pa = jax_arch("fm"), get_arch("fm")
    jp = ra.init_smoke(jax.random.PRNGKey(0))
    model = TFM.FM(pa.smoke_cfg, TFM.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"), device="cpu",
        train=True)
    state = train_state_init(model.param_tree())
    jstate = JO.train_state_init(jp)
    jstep = jax.jit(ra.step_fn("train_batch", smoke=True))
    step = pa.step_fn("train_batch", smoke=True)
    sizes = pa.input_sizes("train_batch", smoke=True)
    stream = JS.recsys_stream(sizes["ids"][0], pa.smoke_cfg.n_fields,
                              pa.smoke_cfg.vocab)
    before = dict(FI.LAUNCHES)
    for _, batch in zip(range(3), stream):
        jb = {k: jnp.asarray(batch[k]) for k in ("ids", "labels")}
        jstate, jm = jstep(jstate, jb)
        state, m = step(model, state, {k: torch.from_numpy(batch[k])
                                       for k in ("ids", "labels")})
        assert set(m) == {"loss", "gnorm"}
        for k in m:
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        _close_leaves(state.mu, jstate.mu, "mu")
        _close_leaves(state.nu, jstate.nu, "nu")
        _close_leaves(state.params, jstate.params, "params", atol=1e-6)
    assert FI.LAUNCHES == before          # the CPU launches nothing


# -- the launcher: checkpoints and resume ----------------------------------

def _join_writers():
    """A crashed run's checkpoint writer finishes (or not) on its own; the
    resumed run starts after it, as a restarted process would."""
    for t in threading.enumerate():
        if t.name == CK.WRITER_THREAD:
            t.join()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "fm",
                                  "granite-moe-1b-a400m"])
def test_launcher_crash_and_resume_is_byte_equal(arch, tmp_path):
    """6 steps with a checkpoint every 3: uninterrupted, and killed after
    step 4 (a crash at the launcher's train.step fault site) then resumed
    with --resume; the final checkpoints are byte-equal."""
    common = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "6",
              "--ckpt-every", "3", "--log-every", "100"]
    whole = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    plan = FaultPlan([FaultSpec("train.step", hit=5)])
    with install(plan), pytest.raises(SimulatedCrash):
        train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    assert plan.fired == [("train.step", 5, "crash")]
    _join_writers()
    assert CK.latest_step(tmp_path / "b") == 3
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--resume"])
    assert resumed["steps"] == 3 and resumed["last_loss"] == (
        whole["last_loss"])
    ma, a = CK.load_checkpoint(tmp_path / "a", 6)
    mb, b = CK.load_checkpoint(tmp_path / "b", 6)
    assert ma == mb
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype
        assert a[key].tobytes() == b[key].tobytes(), key


def test_reference_checkpoint_resumes_in_port(tmp_path, capsys):
    """The reference's launcher writes a checkpoint at step 2 (its keys:
    .params/['embed'], ..., .step); the port restores it into its
    TrainState and continues, and its losses at steps 2 and 3 are the
    reference's own continuation's."""
    args = ["--arch", "qwen3-1.7b", "--smoke", "--log-every", "1"]
    jax_train.main(args + ["--steps", "2", "--ckpt-dir", str(tmp_path),
                           "--ckpt-every", "2"])
    capsys.readouterr()
    want = jax_train.main(args + ["--steps", "4"])
    printed = capsys.readouterr().out
    step2 = float(printed.split("step     2 loss ")[1].split()[0])
    manifest = CK.read_manifest(tmp_path, 2)
    keys = [leaf["key"] for leaf in manifest["leaves"]]
    assert keys[0] == ".params/['embed']" and keys[-1] == ".step"
    got = train.main(args + ["--steps", "4", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--resume"])
    assert got["steps"] == 2
    np.testing.assert_allclose(got["first_loss"], step2, atol=5e-5)
    np.testing.assert_allclose(got["last_loss"], want["last_loss"],
                               rtol=1e-5)


def test_launcher_refusals(monkeypatch):
    """What the launcher refuses: --layers for the FM, the card when there
    is none. A GNN arch trains (it raised before the GNNs were ported)."""
    out = train.main(["--arch", "gatedgcn", "--smoke", "--device", "cpu",
                      "--steps", "2"])
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])
    with pytest.raises(ValueError, match="layers"):
        train.main(["--arch", "fm", "--layers", "1", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


def test_launcher_cuts_depth_and_batch():
    """--layers and --batch reduce a run (the full width kept)."""
    arch = train.cut_layers(get_arch("qwen3-1.7b"), 1)
    assert arch.cfg.n_layers == 1 and arch.cfg.d_model == 2048
    batches = train.make_batches(arch, "train_4k", True, "cpu", batch=2)
    assert next(batches)["tokens"].shape == (2, 128)
    out = train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--layers", "1", "--batch", "2"])
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])


# -- the backward plain versions -------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv,sq,skv", [(4, 2, 7, 7), (4, 4, 5, 9),
                                           (2, 1, 9, 5), (6, 3, 16, 16)])
def test_attention_bwd_ref_equals_autograd_f64(causal, hq, hkv, sq, skv):
    """attention_bwd_ref (P recomputed from the log-sum-exp, D =
    rowsum(dO O), GQA summed over groups) equals torch.autograd through
    attention_ref in float64 to 1e-12; rows with no visible key (causal,
    sq > skv) give 0 and zero gradients."""
    g = torch.Generator().manual_seed(hq * 100 + sq)
    q = torch.randn((2, hq, sq, 8), generator=g, dtype=torch.float64)
    k = torch.randn((2, hkv, skv, 8), generator=g, dtype=torch.float64)
    v = torch.randn((2, hkv, skv, 8), generator=g, dtype=torch.float64)
    do = torch.randn((2, hq, sq, 8), generator=g, dtype=torch.float64)
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    out = ref.attention_ref(qq, kk, vv, causal)
    want = torch.autograd.grad(out, (qq, kk, vv), do)
    o, lse = ref.attention_lse_ref(q, k, v, causal)
    assert torch.equal(o, out.detach())
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(torch.where(
            torch.ones(sq, skv, dtype=torch.bool).tril(skv - sq) if causal
            else torch.ones(sq, skv, dtype=torch.bool),
            torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(
                hq // hkv, 1)) / 8 ** 0.5, float("-inf")), -1).numpy())
    got = ref.attention_bwd_ref(q, k, v, o, do, lse, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


@pytest.mark.parametrize("shared", [False, True])
def test_fm_interaction_bwd_ref_equals_autograd_f64(shared):
    g = torch.Generator().manual_seed(3)
    x = torch.rand((6, 5), generator=g, dtype=torch.float64)
    v = torch.randn((5, 3) if shared else (6, 5, 3), generator=g,
                    dtype=torch.float64)
    go = torch.randn((6,), generator=g, dtype=torch.float64)
    xx, vv = x.clone().requires_grad_(), v.clone().requires_grad_()
    want = torch.autograd.grad(ref.fm_interaction_ref(xx, vv), (xx, vv), go)
    got = ref.fm_interaction_bwd_ref(x, v, go)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)


def test_autograd_functions_on_the_cpu():
    """With grad, the wrappers go through their autograd Functions, whose
    CPU forward and backward are the plain versions: gradients equal
    autograd of the plain forward to float32 rounding; no launch."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 9, 16), generator=g, requires_grad=True)
    k = torch.randn((1, 2, 9, 16), generator=g, requires_grad=True)
    v = torch.randn((1, 2, 9, 16), generator=g, requires_grad=True)
    do = torch.randn((1, 4, 9, 16), generator=g)
    before = dict(FA.LAUNCHES)
    out = FA.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref.attention_ref(q, k, v, True), (q, k, v),
                               do)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    x = torch.ones((1, 1)).expand(3, 5)
    vf = torch.randn((3, 5, 4), generator=g, requires_grad=True)
    (dv,) = torch.autograd.grad(FI.fm_interaction(x, vf).sum(), (vf,))
    (want_dv,) = torch.autograd.grad(ref.fm_interaction_ref(x, vf).sum(),
                                     (vf,))
    np.testing.assert_allclose(dv.numpy(), want_dv.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert FA.LAUNCHES == before
