"""The dry run's half of the arch contract (repro_torch.configs.base:
input_specs, state_specs, the LM serve steps, model_flops, _tree_bytes,
the traffic models; configs.all_archs; launch.mesh.HARDWARE) against the
JAX package's, and launch/dryrun.py on the meta device.

Specs are compared leaf for leaf (shape and dtype) with the reference's
ShapeDtypeStructs; counts and traffic models exactly, the reference's at
a 1 x 1 mesh built explicitly from one device (some test files force 8
host devices). The reference's specs are taken with x64 off: the JAX
engine turns it on process-wide when imported, and then the GNNs' norm
gains and biases (``jnp.ones``, ``jnp.zeros``) default to float64, where
the models' trees are float32. The serve steps run the smoke configs on the same weights
(params_from_numpy) at tests/test_torch_serve.py's rtol = atol = 1e-4.
FLOPs are not compared with XLA's, which count elementwise work too: the
dry run's are held to a closed form."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES, base as JB
from repro.configs import all_archs as jax_all_archs, get_arch as jax_arch
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, all_archs, base as B, get_arch
from repro_torch.kernels import flash_attention as FA, launch_counts
from repro_torch.kernels import segment_reduce as SR
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HARDWARE
from repro_torch.models import transformer as T
from repro_torch.training.optim import tree_leaves

LM_ARCHS = [n for n in ARCH_NAMES if get_arch(n).family == "lm"]
CELLS = [(n, s) for n in ARCH_NAMES for s in get_arch(n).shapes]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run's xdist workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _leaf_specs(tree):
    return [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(tree)]


def _jax_leaf_specs(tree):
    return [(tuple(x.shape), jnp.dtype(x.dtype).name)
            for x in jax.tree.leaves(tree)]


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_all_archs_is_the_registry():
    assert list(all_archs()) == list(ARCH_NAMES) == list(JAX_ARCH_NAMES)
    assert list(jax_all_archs()) == list(ARCH_NAMES)
    assert all(a is get_arch(n) for n, a in all_archs().items())


def test_hardware_is_the_h100s():
    assert HARDWARE["peak_flops_bf16"] == 989e12
    assert HARDWARE["hbm_bw"] == 3.35e12
    assert HARDWARE["hbm_bytes"] == 80e9
    assert "ici_bw_per_link" not in HARDWARE        # one card


@pytest.mark.parametrize("name", ARCH_NAMES)
@pytest.mark.parametrize("smoke", [False, True])
def test_specs_match_the_reference(name, smoke):
    """input_specs and state_specs of every shape, leaf for leaf, on the
    meta device (the full configs allocate nothing)."""
    pa, ra = get_arch(name), jax_arch(name)
    for shape in pa.shapes:
        inputs, state = pa.input_specs(shape, smoke), pa.state_specs(
            shape, smoke)
        assert all(t.device.type == "meta"
                   for t in tree_leaves(inputs) + tree_leaves(state))
        with jax.enable_x64(False):
            want_inputs = ra.input_specs(shape, smoke)
            want_state = ra.state_specs(shape, smoke)
        assert _leaf_specs(inputs) == _jax_leaf_specs(want_inputs), shape
        assert _leaf_specs(state) == _jax_leaf_specs(want_state), shape
        assert pa.input_sizes(shape, smoke) == {
            k: tuple(v.shape) for k, v in ra.input_specs(shape, smoke).items()
            if not isinstance(v, JT.KVCache)}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_model_flops_and_traffic_match_the_reference(name):
    pa, ra = get_arch(name), jax_arch(name)
    mesh = _one_device_mesh()
    model = {"lm": B.lm_traffic_model, "gnn": B.gnn_traffic_model,
             "recsys": B.recsys_traffic_model}[pa.family]
    jmodel = {"lm": JB.lm_traffic_model, "gnn": JB.gnn_traffic_model,
              "recsys": JB.recsys_traffic_model}[pa.family]
    for shape in pa.shapes:
        assert pa.model_flops(shape) == ra.model_flops(shape), shape
        with jax.enable_x64(False):
            want = jmodel(ra, mesh, shape)
            state, inputs = (JB._tree_bytes(ra.state_specs(shape)),
                             JB._tree_bytes(ra.input_specs(shape)))
        assert model(pa, B.ONE_CARD, shape) == want, shape
        assert B._tree_bytes(pa.state_specs(shape)) == state
        assert B._tree_bytes(pa.input_specs(shape)) == inputs


def test_a_cut_batch_scales_the_reckoning():
    a = get_arch("qwen3-1.7b")
    full, cut = (B.lm_traffic_model(a, B.ONE_CARD, "decode_32k", batch=b)
                 for b in (None, 16))
    kv = 2 * 28 * 8 * 32768 * 128 * 2
    assert cut["state_bytes"] == full["state_bytes"]
    assert cut["bytes"] - cut["state_bytes"] == 2 * (16 * kv + 16 * 4 * 2)
    assert a.input_specs("decode_32k", batch=16)["cache"].k.shape[1] == 16
    fm = get_arch("fm")
    assert B.recsys_traffic_model(fm, B.ONE_CARD, "serve_bulk",
                                  batch=512) == (
        B.recsys_traffic_model(fm, B.ONE_CARD, "serve_p99"))


def _models(name):
    ra, pa = jax_arch(name), get_arch(name)
    params = JT.init_params(jax.random.PRNGKey(0), ra.smoke_cfg)
    model = T.Transformer(pa.smoke_cfg, T.params_from_numpy(
        jax.tree.map(np.asarray, params), pa.smoke_cfg, "cpu"), device="cpu")
    return ra, pa, params, model


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_serve_steps_match_the_reference(name):
    """serve_prefill and serve_decode of the smoke config at prefill_32k's
    and decode_32k's smoke inputs (4 x 128; a cache of 128 positions
    filled to ragged lengths) against the reference's."""
    ra, pa, params, model = _models(name)
    rng = np.random.default_rng(3)
    cfg = pa.smoke_cfg
    tokens = rng.integers(0, cfg.vocab, size=(4, 128)).astype(np.int32)
    jl, jlen = jax.jit(ra.step_fn("prefill_32k", smoke=True))(
        params, {"tokens": jnp.asarray(tokens)})
    logits, length = pa.step_fn("prefill_32k", smoke=True)(
        model, {"tokens": torch.from_numpy(tokens)})
    _close(logits, jl)
    assert length.tolist() == np.asarray(jlen).tolist() == [128] * 4

    spec = pa.input_specs("decode_32k", smoke=True)["cache"]
    lengths = np.array([127, 64, 1, 100], np.int32)
    kv = rng.normal(size=(2,) + tuple(spec.k.shape)).astype(np.float32)
    kv *= (np.arange(128) < lengths[:, None, None])[None, None, :, :, :,
                                                    None]
    token = rng.integers(0, cfg.vocab, size=(4, 1)).astype(np.int32)
    jcache = JT.KVCache(jnp.asarray(kv[0]), jnp.asarray(kv[1]),
                        jnp.asarray(lengths))
    jl, jc = jax.jit(ra.step_fn("decode_32k", smoke=True))(
        params, {"token": jnp.asarray(token), "cache": jcache})
    cache = T.KVCache(torch.from_numpy(kv[0].copy()),
                      torch.from_numpy(kv[1].copy()),
                      torch.from_numpy(lengths))
    logits, out = pa.step_fn("decode_32k", smoke=True)(
        model, {"token": torch.from_numpy(token), "cache": cache})
    _close(logits, jl)
    _close(out.k, jc.k)
    _close(out.v, jc.v)
    assert out.length.tolist() == np.asarray(jc.length).tolist()
    assert out.k is cache.k             # written in place
    with pytest.raises(ValueError, match="config"):
        pa.step_fn("decode_32k")(model, {"token": torch.from_numpy(token),
                                         "cache": cache})


def test_decode_at_position_524287_pins_rope():
    """One decode step of qwen3's smoke config at the last position of
    long_500k's cache (float32 angles near 2**19): logits and the
    token's K and V as the reference's."""
    ra, pa, params, model = _models("qwen3-1.7b")
    cfg = pa.smoke_cfg
    S = 524288
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, 1, cfg.n_kv_heads, S, cfg.hd)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    k[:, :, :, -64:-1] = rng.normal(size=k[:, :, :, -64:-1].shape)
    v[:, :, :, -64:-1] = rng.normal(size=v[:, :, :, -64:-1].shape)
    token = np.array([[7]], np.int32)
    jl, jc = jax.jit(ra.step_fn("long_500k", smoke=True))(params, {
        "token": jnp.asarray(token), "cache": JT.KVCache(
            jnp.asarray(k), jnp.asarray(v), jnp.full((1,), S - 1,
                                                     jnp.int32))})
    cache = T.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                      torch.full((1,), S - 1, dtype=torch.int32))
    logits, out = pa.step_fn("long_500k", smoke=True)(
        model, {"token": torch.from_numpy(token), "cache": cache})
    _close(logits, jl)
    _close(out.k[:, :, :, -1], np.asarray(jc.k)[:, :, :, -1])
    _close(out.v[:, :, :, -1], np.asarray(jc.v)[:, :, :, -1])
    assert out.length.tolist() == [S]


def test_the_wrappers_take_the_plain_shapes_on_meta():
    """On meta tensors the kernel wrappers run their plain versions'
    shapes and launch nothing; a CPU and a meta tensor together are
    neither route."""
    meta = torch.device("meta")
    before = launch_counts()
    q = torch.empty((2, 4, 5000, 16), device=meta)
    k = torch.empty((2, 2, 5000, 16), device=meta)
    assert FA.flash_attention(q, k, k).shape == q.shape
    assert FA.flash_decode(q[:, :, 0], k, k, 7).shape == (2, 4, 16)
    vals = torch.empty((10, 3), device=meta, requires_grad=True)
    ids = torch.empty((10,), dtype=torch.int32, device=meta)
    out = SR.segment_reduce(vals, ids, 4, "max")
    assert out.shape == (4, 3) and out.device.type == "meta"
    out.sum().backward()
    assert vals.grad.shape == vals.shape
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_decode(torch.zeros((2, 4, 16)), k, k, 7)


# -- launch/dryrun.py ---------------------------------------------------------

@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return dryrun.main(["--out", str(out)]), out


def test_every_cell_passes_on_meta(cells):
    results, out = cells
    assert sorted(results) == sorted(f"{a}__{s}__1xH100" for a, s in CELLS)
    keys = {"arch", "shape", "mesh", "n_devices", "ok", "trace_s", "memory",
            "cost_per_device", "bf16_collective_adjust", "roofline"}
    for tag, r in results.items():
        assert r["ok"] and set(r) == keys, tag
        assert (out / f"{tag}.json").exists()
        assert r["mesh"] == "1xH100" and r["n_devices"] == 1
        assert set(r["memory"]) == {
            "state_bytes_per_device", "traffic_bytes_per_device",
            "act_bytes_per_device", "io_bytes_per_device", "fits_80gb_hbm",
            "resident_fits_80gb_hbm"}
        c = r["cost_per_device"]
        assert set(c) == {"flops", "bytes_accessed", "transcendentals",
                          "collective_bytes", "collective_counts",
                          "layer_scaled"}
        assert not any(c["collective_bytes"].values())
        assert c["layer_scaled"] == (get_arch(r["arch"]).family == "lm")
        assert c["bytes_accessed"] > 0
        roof = r["roofline"]
        assert set(roof) == {"compute_s", "memory_s", "collective_s",
                             "dominant", "step_s_lower_bound",
                             "model_flops_per_device", "useful_flops_ratio"}
        assert roof["memory_s"] == (r["memory"]["traffic_bytes_per_device"]
                                    / 3.35e12)
        assert roof["step_s_lower_bound"] == max(roof["compute_s"],
                                                 roof["memory_s"])
    qwen = results["qwen3-1.7b__long_500k__1xH100"]["memory"]
    assert qwen["resident_fits_80gb_hbm"]
    assert not results["qwen3-1.7b__decode_32k__1xH100"]["memory"][
        "resident_fits_80gb_hbm"]


def _qwen3_flops(shape):
    """The closed form: every projection's 2 m n k (q, k, v, o and the
    three FFN weights of each layer), the unembedding's, and the plain
    attention's two products (Q K^T and P V). prefill_32k: the blockwise
    plain version's q x kv blocks of 2048, those the causal mask hides
    whole skipped (16 * 17 / 2 of 256), and the unembedding of the last
    position only. train_4k: attention_lse_ref's two whole [S, S]
    products; remat runs each layer's forward again in the backward,
    except its last product (the FFN's output projection, whose result
    the backward does not need); the backward is twice a matmul's
    forward, and attention_bwd_ref's five products (the scores again,
    dV, dP, dQ, dK)."""
    c = get_arch("qwen3-1.7b").cfg
    sizes = get_arch("qwen3-1.7b").shapes[shape].sizes
    b, S = sizes["global_batch"], sizes["seq_len"]
    tokens = b * S
    d, hd, f, V, L = c.d_model, c.hd, c.d_ff, c.vocab_padded, c.n_layers
    proj = 2 * tokens * d * hd * (2 * c.n_heads + 2 * c.n_kv_heads)
    ffn = 3 * 2 * tokens * d * f
    if shape == "prefill_32k":
        n = S // 2048
        attn = n * (n + 1) // 2 * 2 * (2 * b * c.n_heads * 2048 * 2048 * hd)
        return L * (proj + ffn + attn) + 2 * b * d * V
    product = 2 * b * c.n_heads * S * S * hd
    w_out = 2 * tokens * f * d
    layer = (proj + ffn) * 4 - w_out + (2 * 2 + 5) * product
    return L * layer + 3 * 2 * tokens * d * V


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_qwen3_flops_are_the_closed_form(cells, shape):
    results, _ = cells
    got = results[f"qwen3-1.7b__{shape}__1xH100"]["cost_per_device"]["flops"]
    assert got == _qwen3_flops(shape)


def test_a_failing_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    def broken(arch, shape_name):
        raise RuntimeError("no lowering")
    monkeypatch.setattr(dryrun, "_run", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "fm", "--shape", "serve_p99", "--out",
                     str(tmp_path)])
    assert e.value.code == 1
    import json
    r = json.loads((tmp_path / "fm__serve_p99__1xH100.json").read_text())
    assert not r["ok"] and "no lowering" in r["traceback"]
