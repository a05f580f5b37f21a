"""The port's AdamW (repro_torch.training.optim) against the JAX
package's on the CPU, fed the same (the reference's) gradients: the
schedule, global-norm clipping and the update, with float32 and bfloat16
parameters.

Tolerances: the schedule, the norm and the clipped gradients to float32
rounding (rtol 1e-6). After several updates the moments and float32
parameters to 1e-6 of each value plus 1e-6 of the leaf's largest value:
each is a few float32 roundings of one formula taken in the same order,
but the clipping scale may differ in its last bit, which moves every
clipped gradient by one unit, and a moment that sums gradients of both
signs keeps that unit of its terms, not of itself. bfloat16 parameters to
one bfloat16 unit (a float32 difference in the last bit may round the
other way)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import optim as JO
from repro_torch.training import optim as O


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(rng):
    """A parameter tree of the LM's form (nested dicts, a 0-d leaf), with
    leaves of distinct scales."""
    return {"embed": rng.normal(size=(40, 8)).astype(np.float32),
            "ln_f": np.zeros((8,), np.float32),
            "layers": {"wq": rng.normal(size=(2, 8, 16)).astype(np.float32)
                       * 0.3,
                       "w_out": rng.normal(size=(2, 16, 8)).astype(
                           np.float32) * 0.1},
            "b": np.asarray(0.25, np.float32)}


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_torch(tree, dtype):
    return O.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dtype),
                      tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close_f32(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999,
                                  10_000, 20_000])
def test_schedule(step):
    cfg = JO.AdamWConfig()
    want = JO.schedule(cfg, jnp.asarray(step, jnp.float32))
    got = O.schedule(O.AdamWConfig(), torch.tensor(float(step)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_by_global_norm(dtype, max_norm):
    rng = np.random.default_rng(1)
    g = _tree(rng)
    want, wn = JO.clip_by_global_norm(_to_jax(g, jnp.dtype(dtype)), max_norm)
    got, gn = O.clip_by_global_norm(_to_torch(g, getattr(torch, dtype)),
                                    max_norm)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
    for a, b in zip(O.tree_leaves(got), jax.tree.leaves(want)):
        assert str(a.dtype).endswith(dtype)
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6 if
                                   dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", [
    JO.AdamWConfig(),
    JO.AdamWConfig(lr=1e-3, weight_decay=0.0, warmup_steps=2,
                   total_steps=6, clip_norm=0.5)])
def test_adamw_update_matches_reference(dtype, cfg):
    """Six updates, each fed the same gradients (the reference's), drawn
    afresh a step; the port writes its state in place."""
    rng = np.random.default_rng(2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = _tree(rng)
    jstate = JO.train_state_init(_to_jax(p0, jdt))
    state = O.train_state_init(_to_torch(p0, tdt))
    params = state.params
    for _ in range(6):
        g = _tree(rng)
        g["layers"]["wq"] *= 30            # a norm that clips
        jstate, wn = JO.adamw_update(jstate, _to_jax(g, jdt), cfg)
        state, gn = O.adamw_update(state, _to_torch(g, tdt),
                                   O.AdamWConfig(*cfg))
        assert state.params is params      # written in place
        np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-6)
        assert int(state.step) == int(jstate.step)
        for got, want in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            for a, b in zip(O.tree_leaves(got), jax.tree.leaves(want)):
                assert a.dtype == torch.float32
                _close_f32(_np(a), _np(b))
        for a, b in zip(O.tree_leaves(state.params),
                        jax.tree.leaves(jstate.params)):
            assert a.dtype == tdt
            if dtype == "float32":
                _close_f32(_np(a), _np(b))
            else:   # one bfloat16 unit of the value
                unit = np.exp2(np.floor(np.log2(np.maximum(
                    np.abs(_np(b)), 1e-30))) - 7)
                assert (np.abs(_np(a) - _np(b)) <= unit).all()


def test_adamw_converges_quadratic():
    """The reference's test_adamw_converges_quadratic on the port."""
    state = O.train_state_init({"x": torch.tensor([5.0, -3.0])})
    cfg = O.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=0,
                        total_steps=1000)
    for _ in range(200):
        state, _ = O.adamw_update(state, {"x": state.params["x"].clone()},
                                  cfg)
    assert float(state.params["x"].abs().max()) < 0.05


def test_train_state_layout():
    """The state's leaves in JAX's flatten order, moments float32, step
    an int32 scalar."""
    params = _to_torch(_tree(np.random.default_rng(3)),
                       torch.bfloat16)
    state = O.train_state_init(params)
    want = jax.tree.leaves(JO.train_state_init(
        _to_jax(_tree(np.random.default_rng(3)), jnp.bfloat16)))
    got = (O.tree_leaves(state.params) + O.tree_leaves(state.mu)
           + O.tree_leaves(state.nu) + [state.step])
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert [str(t.dtype).split(".")[-1] for t in got] == [
        str(w.dtype) for w in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_in_slices_gives_the_whole_leaf_bits(dtype, monkeypatch):
    """adamw_update takes a large leaf in slices of its first axis (CHUNK
    elements), which bounds its float32 temporaries: the arithmetic is
    elementwise, so three steps give the same parameters and moments,
    bit for bit, as with each leaf whole."""
    def run(chunk):
        monkeypatch.setattr(O, "CHUNK", chunk)
        gen = torch.Generator().manual_seed(0)
        params = {"w": torch.randn((5, 30, 7), generator=gen).to(dtype),
                  "b": torch.randn(9, generator=gen).to(dtype)}
        state = O.train_state_init(params)
        for i in range(3):
            g = torch.Generator().manual_seed(i + 1)
            grads = {k: torch.randn(v.shape, generator=g).to(dtype)
                     for k, v in params.items()}
            state, _ = O.adamw_update(state, grads, O.AdamWConfig(
                warmup_steps=0))
        return state

    whole, sliced = run(1 << 26), run(2 * 30 * 7)
    assert len(O._slices(*[whole.params["w"]] * 4)) == 3   # 2 + 2 + 1 rows
    monkeypatch.setattr(O, "CHUNK", 1 << 26)
    assert len(O._slices(*[whole.params["w"]] * 4)) == 1
    for part in ("params", "mu", "nu"):
        for a, b in zip(O.tree_leaves(getattr(whole, part)),
                        O.tree_leaves(getattr(sliced, part))):
            assert torch.equal(a, b)
