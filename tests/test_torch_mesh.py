"""Model sharding over a device mesh: the port's ``launch.mesh``,
``models.common.maybe_shard`` / ``placements``, the sharding specs and
per-device bytes of ``configs.base``, the mesh layout of the models and
the production-mesh dry run, against the JAX package.

- Specs (``param_pspecs``, ``fsdp_pspecs``, ``shardings``) are compared
  leaf for leaf with the reference's ``PartitionSpec`` trees, and
  ``_sharded_bytes`` and the traffic models exactly, for every arch x
  shape on the reference's two production meshes. The reference is
  called with a stand-in mesh that has ``axis_names`` and
  ``devices.shape``, all that its functions read, so no test needs 512
  JAX devices. Its specs are taken with x64 off, as
  tests/test_torch_dryrun.py does.
- ``maybe_shard``'s resolution, on cases written out from the
  reference's code (``repro/models/common.py``).
- Four ranks in threads (``multi_threaded_pg``) on a (2, 2) ("data",
  "model") mesh of the CPU run qwen3's and granite-moe-3b's smoke
  configs (prefill and 4 greedy decode steps) and one FSDP train step of
  chatglm3's: logits, loss, gradients and the updated parameters equal
  the unmeshed port's within 1e-5 of scale (float32; the mesh moves
  partial sums between devices, so sums are added in another order),
  the greedy tokens exactly, and the JAX reference's at
  tests/test_torch_serve.py's rtol = atol = 1e-4 (logits) and
  tests/test_torch_train.py's rtol 1e-5 (loss).
- The production-mesh dry run on the meta device under the fake process
  group, its LM cells cut to 2 layers (the costs are those at 1 and 2
  layers, which ``run_cell`` counts anyway), and a closed form of a
  dense prefill's collectives.

Each test that brings up a process group tears it down."""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec

from repro.configs import base as JB
from repro.configs import get_arch as jax_arch
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, base as B, get_arch
from repro_torch.launch import dryrun, mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.common import (
    P, active_abstract_mesh, maybe_shard, placements, resolve_spec,
)
from repro_torch.training.optim import TrainState, train_state_init, tree_leaves

CELLS = [(n, s) for n in ARCH_NAMES for s in get_arch(n).shapes]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tier-1 run's xdist workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class StandIn:
    """What the spec functions read of a mesh: the reference's read
    ``axis_names`` and ``devices.shape``, the port's ``axis_names`` and
    ``axis_sizes``."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.axis_sizes = shape
        self.devices = np.empty(shape, dtype=np.int8)


def _canon(tree):
    """A spec tree (either package's) as plain data: specs as tuples,
    dicts by key, NamedTuples by type name and fields."""
    if isinstance(tree, (P, PartitionSpec)):
        return ("P",) + tuple(tree)
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(_canon(v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return tuple(_canon(v) for v in tree)
    return tree


def _once_a_shape(arch):
    """A copy of a reference arch whose ``state_specs`` (an abstract
    trace of its init) runs once a shape: its spec functions call it
    again and again."""
    arch = dataclasses.replace(arch)
    object.__setattr__(arch, "state_specs",
                       functools.lru_cache(maxsize=None)(arch.state_specs))
    return arch


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_specs_and_bytes_match_the_reference(name, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = StandIn(shape, names)
    pa, ra = get_arch(name), _once_a_shape(jax_arch(name))
    traffic = {"lm": (B.lm_traffic_model, JB.lm_traffic_model),
               "gnn": (B.gnn_traffic_model, JB.gnn_traffic_model),
               "recsys": (B.recsys_traffic_model, JB.recsys_traffic_model)
               }[pa.family]
    assert B.data_axes(mesh) == JB.data_axes(mesh)
    with jax.enable_x64(False):
        if pa.family == "lm":
            assert _canon(pa.param_pspecs(mesh)) == _canon(
                ra.param_pspecs(mesh))
            assert _canon(pa.fsdp_pspecs(mesh)) == _canon(
                ra.fsdp_pspecs(mesh))
        for shape_name in pa.shapes:
            got = pa.shardings(mesh, shape_name)
            want = ra.shardings(mesh, shape_name)
            assert _canon(got) == _canon(want), shape_name
            (state_sp, batch_sp), _ = got
            (jstate_sp, jbatch_sp), _ = want
            assert B._sharded_bytes(
                pa.state_specs(shape_name), state_sp, mesh) == (
                JB._sharded_bytes(ra.state_specs(shape_name), jstate_sp,
                                  mesh)), shape_name
            assert B._sharded_bytes(
                pa.input_specs(shape_name), batch_sp, mesh) == (
                JB._sharded_bytes(ra.input_specs(shape_name), jbatch_sp,
                                  mesh)), shape_name
            assert traffic[0](pa, mesh, shape_name) == traffic[1](
                ra, mesh, shape_name), shape_name


def test_granite_3b_runs_tensor_parallel_inside_each_expert():
    """40 experts do not divide a 16-way "model": d_ff is split instead;
    granite-1b's 32 do, so its experts are."""
    mesh = StandIn((16, 16), ("data", "model"))
    moe3 = get_arch("granite-moe-3b-a800m").param_pspecs(mesh)["layers"]["moe"]
    moe1 = get_arch("granite-moe-1b-a400m").param_pspecs(mesh)["layers"]["moe"]
    assert moe3["w_in"] == P(None, None, None, "model")
    assert moe3["w_out"] == P(None, None, "model", None)
    assert moe1["w_in"] == P(None, "model", None, None)


def test_the_one_card_mesh_keeps_the_one_card_numbers():
    """At the 1 x 1 mesh every tree is whole: the traffic models give
    what they gave on one card (state and inputs unsharded)."""
    for name, shape_name in CELLS:
        a = get_arch(name)
        t = dryrun.traffic(a, shape_name)
        assert t["state_bytes"] == B._tree_bytes(a.state_specs(shape_name))


# -- maybe_shard -----------------------------------------------------------------

SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("sizes, shape, entries, want", [
    # "dp": every axis but "model"
    (SINGLE, (32, 8, 4), ("dp", None, None), P("data", None, None)),
    (MULTI, (64, 8, 4), ("dp", None, None),
     P(("pod", "data"), None, None)),
    # "all": every axis, major first
    (SINGLE, (256, 4), ("all", None), P(("data", "model"), None)),
    (MULTI, (512, 4), ("all", None), P(("pod", "data", "model"), None)),
    # a dim that its axes' product does not divide stays whole
    (MULTI, (16, 4096, 8), ("dp", "model", None), P(None, "model", None)),
    (SINGLE, (256, 24, 4), (None, "model", None), P(None, None, None)),
    (MULTI, (256, 4), ("all", None), P(None, None)),
    # "model" on a mesh without it
    ({"data": 4}, (8, 8), ("data", "model"), P("data", None)),
    ({"data": 4}, (8,), ("dp",), P("data")),
    # an axis name, and a tuple of names, as given
    (SINGLE, (16, 32), ("model", ("data",)), P("model", ("data",))),
])
def test_maybe_shard_resolution(sizes, shape, entries, want):
    assert resolve_spec(shape, entries, sizes) == want


def test_maybe_shard_is_a_no_op_without_a_mesh_or_a_dtensor():
    x = torch.ones(4, 4)
    assert active_abstract_mesh() is None
    assert maybe_shard(x, "dp", "model") is x
    with M.use_mesh(StandIn((2, 2), ("data", "model"))) as m:
        assert active_abstract_mesh() is m
        assert maybe_shard(x, "dp", "model") is x       # not a DTensor
    assert active_abstract_mesh() is None


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")
    assert placements(P(("pod", "data"), None, "model"), Names) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(None, None), Names) == (Replicate(),) * 3


# -- four ranks in threads on a (2, 2) mesh ------------------------------------

def run_threaded(world_size, fn):
    """``fn(rank)`` in ``world_size`` threads, each rank of a threaded
    process group (torch's ``multi_threaded_pg``); returns the results by
    rank, and tears the group down."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg,
    )
    # sharding propagation runs ops on fake tensors under one lock a
    # process; threads take turns on it
    lock = ShardingPropagator._fake_mode_lock
    ShardingPropagator._fake_mode_lock = threading.Lock()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _install_threaded_pg()
    store = dist.HashStore()
    results, errors = {}, []

    def worker(rank):
        dist.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            torch.set_num_threads(1)
            results[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append((rank, e))
            ProcessLocalGroup.exception_handle(e)
        finally:
            dist.destroy_process_group()

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(world_size)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "a rank hung"
        ProcessLocalGroup.reset()
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        ShardingPropagator._fake_mode_lock = lock
    if errors:
        raise errors[0][1]
    assert not dist.is_initialized()
    return results


def _cpu_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def _models(name):
    """(reference params, its config, the port's config, the port's
    params) from the same JAX init."""
    ra, pa = jax_arch(name), get_arch(name)
    jparams = JT.init_params(jax.random.PRNGKey(0), ra.smoke_cfg)
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, ra.smoke_cfg, pa, tree


def _close(got, want, share=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=share * float(np.abs(want).max()))


SERVE_STEPS = 4


def _serve_unmeshed(model, tokens, cap):
    logits, cache = model.prefill(tokens, capacity=cap)
    out = [logits]
    for _ in range(SERVE_STEPS):
        tok = out[-1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = model.decode_step(tok, cache)
        out.append(logits)
    return out


def _serve_jax(params, cfg, tokens, cap):
    logits, cache = jax.jit(lambda p, t: JT.prefill(p, cfg, t))(
        params, jnp.asarray(tokens))
    pad = cap - tokens.shape[1]
    cache = cache._replace(
        k=jnp.pad(cache.k, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))),
        v=jnp.pad(cache.v, ((0, 0), (0, 0), (0, 0), (0, pad), (0, 0))))
    decode = jax.jit(lambda p, t, c: JT.decode_step(p, cfg, t, c))
    out = [np.asarray(logits)]
    for _ in range(SERVE_STEPS):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        logits, cache = decode(params, tok, cache)
        out.append(np.asarray(logits))
    return out


@pytest.mark.parametrize("name", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_serve_on_a_2x2_mesh_equals_the_unmeshed_port_and_jax(name):
    """Prefill of 4 x 12 tokens and 4 greedy decode steps, the state and
    inputs placed by ``shardings(mesh, "prefill_32k")`` and, for the
    decode, the cache moved to ``shardings(mesh, "decode_32k")``'s
    layout, as a server would hand it over."""
    jparams, jcfg, pa, tree = _models(name)
    cfg = pa.smoke_cfg
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(4, 12),
                                              dtype=np.int32)
    cap = 12 + SERVE_STEPS
    plain = _serve_unmeshed(T.Transformer(
        cfg, T.params_from_numpy(tree, cfg, "cpu"), device="cpu"),
        torch.from_numpy(tokens), cap)
    want = _serve_jax(jparams, jcfg, tokens, cap)
    for got, ref in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)

    def rank(_):
        mesh = _cpu_mesh()
        with M.use_mesh(mesh):
            (state_sp, batch_sp), _ = pa.shardings(mesh, "prefill_32k",
                                                    smoke=True)
            model = T.Transformer(cfg, B.place(T.params_from_numpy(
                tree, cfg, "cpu"), state_sp, mesh), device="cpu")
            assert model.meshed
            batch = B.place({"tokens": torch.from_numpy(tokens)}, batch_sp,
                            mesh)
            logits, cache = model.prefill(batch["tokens"], capacity=cap)
            out = [logits.full_tensor()]
            (_, dec_sp), _ = pa.shardings(mesh, "decode_32k", smoke=True)
            cache = T.KVCache(*(
                t.redistribute(mesh, placements(sp, mesh))
                for t, sp in zip(cache, dec_sp["cache"])))
            for _ in range(SERVE_STEPS):
                tok = out[-1].argmax(-1, keepdim=True).to(torch.int32)
                tok = B.place({"token": tok}, {"token": dec_sp["token"]},
                              mesh)["token"]
                logits, cache = model.decode_step(tok, cache)
                out.append(logits.full_tensor())
            return out

    for outs in run_threaded(4, rank).values():
        for got, p, ref in zip(outs, plain, want):
            assert torch.equal(got.argmax(-1), p.argmax(-1))
            _close(got, p.numpy())
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("rows", [4, 2])
def test_fsdp_train_step_on_a_2x2_mesh_equals_the_unmeshed_port_and_jax(rows):
    """One train_4k step of chatglm3's smoke config under its FSDP layout
    (``fsdp_pspecs``, ``batch_shard_all``): loss, every gradient leaf and
    the updated parameters. 4 rows split over both axes; 2 do not, so
    the batch goes over "data" and the sequence over "model" (the
    reference's DP x SP fallback, ``_fsdp_shard``; the projections then
    run through ``models.common.matmul``)."""
    jparams, jcfg, pa, tree = _models("chatglm3-6b")
    cfg = dataclasses.replace(pa.smoke_cfg, batch_shard_all=True)
    arch = dataclasses.replace(pa, smoke_cfg=cfg)
    assert pa.fsdp_train
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, cfg.vocab, size=(rows, 16), dtype=np.int32)
             for k in ("tokens", "labels")}
    step = arch.step_fn("train_4k", smoke=True)

    def fresh():
        return T.Transformer(cfg, T.params_from_numpy(tree, cfg, "cpu"),
                             device="cpu", train=True)
    model = fresh()
    state, metrics = step(model, train_state_init(model.param_tree()),
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = [g.clone() for g in tree_leaves(model.grads)]
    params = [p.detach().clone() for p in tree_leaves(state.params)]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, _ = jax.jit(lambda p: JT.loss_fn(p, jcfg, jb["tokens"],
                                            jb["labels"]))(jparams)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                               rtol=1e-5)

    def rank(_):
        mesh = _cpu_mesh()
        with M.use_mesh(mesh):
            (state_sp, batch_sp), _ = arch.shardings(mesh, "train_4k",
                                                     smoke=True)
            assert batch_sp["tokens"] == P(("data", "model"), None)
            if rows == 2:      # the batch spec drops "model" (2 % 4)
                batch_sp = {k: P("data", None) for k in batch_sp}
            m = T.Transformer(cfg, B.place(T.params_from_numpy(
                tree, cfg, "cpu"), state_sp.params, mesh), device="cpu",
                train=True)
            s0 = train_state_init(m.param_tree())
            s0 = TrainState(m.param_tree(), B.place(s0.mu, state_sp.mu, mesh),
                            B.place(s0.nu, state_sp.nu, mesh), s0.step)
            s1, met = step(m, s0, B.place(
                {k: torch.from_numpy(v) for k, v in batch.items()}, batch_sp,
                mesh))
            return (float(met["loss"].full_tensor()),
                    [g.full_tensor() for g in tree_leaves(m.grads)],
                    [p.detach().full_tensor() for p in tree_leaves(s1.params)])

    for loss, g, p in run_threaded(4, rank).values():
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
        for a, b in zip(g, grads):
            _close(a, b.numpy())
        for a, b in zip(p, params):
            _close(a, b.numpy())


# -- the production-mesh dry run ---------------------------------------------

DRY_CELLS = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "long_500k"),
             ("granite-moe-3b-a800m", "train_4k"), ("gatedgcn", "full_graph_sm"),
             ("fm", "serve_p99")]


@pytest.fixture
def production(monkeypatch):
    """The dry run's archs with the LMs cut to 2 layers; the fake group
    torn down after the test."""
    monkeypatch.setattr(dryrun, "get_arch", lambda name: _cut(name, 2))
    yield
    M.destroy_process_group()
    assert not dist.is_initialized()


def _cut(name, layers):
    a = get_arch(name)
    return dryrun._at_depth(a, layers) if a.family == "lm" else a


@pytest.mark.parametrize("name, shape_name", DRY_CELLS)
def test_the_production_mesh_dry_run_passes_on_meta(production, name,
                                                     shape_name):
    res = dryrun.run_cell(name, shape_name, multi_pod=False)
    assert res["ok"] and res["mesh"] == "16x16" and res["n_devices"] == 256
    mesh = StandIn((16, 16), ("data", "model"))
    a = _cut(name, 2)
    (state_sp, batch_sp), _ = a.shardings(mesh, shape_name)
    mem = res["memory"]
    assert mem["state_bytes_per_device"] == B._sharded_bytes(
        a.state_specs(shape_name), state_sp, mesh)
    assert mem["io_bytes_per_device"] == B._sharded_bytes(
        a.input_specs(shape_name), batch_sp, mesh)
    assert mem["fits_80gb_hbm"]
    c = res["cost_per_device"]
    assert set(c["collective_bytes"]) == set(dryrun.COLLECTIVES)
    assert sum(c["collective_counts"].values()) > 0
    roof = res["roofline"]
    weighted = 2 * c["collective_bytes"]["all-reduce"] + sum(
        v for k, v in c["collective_bytes"].items() if k != "all-reduce")
    assert roof["collective_s"] == weighted / M.HARDWARE["link_bw"]
    assert roof["step_s_lower_bound"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])


def test_a_dense_prefill_s_collectives_are_the_closed_form(production):
    """qwen3-1.7b prefill_32k on 16 x 16, b = 32 / 16 = 2 rows a device:
    the vocab-parallel lookup's all-reduce, and each layer's two
    row-parallel products' (wo, w_out), each of the [2, S, d] residual;
    each layer all-gathers k and v ([2, S, 8 x 128]: 8 KV heads do not
    split over 16)."""
    mesh = M.make_production_mesh()
    a = get_arch("qwen3-1.7b")
    cfg = a.cfg
    S = a.shapes["prefill_32k"].sizes["seq_len"]
    for layers in (1, 2):
        c = dryrun._costs(_cut("qwen3-1.7b", layers), "prefill_32k",
                               mesh)
        resid = 2 * S * cfg.d_model * 2
        kv = 2 * S * cfg.n_kv_heads * cfg.hd * 2
        assert c["collective_counts"] == {
            "all-reduce": 1 + 2 * layers, "all-gather": 2 * layers,
            "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
        assert c["collective_bytes"]["all-reduce"] == (1 + 2 * layers) * resid
        assert c["collective_bytes"]["all-gather"] == 2 * layers * kv


def test_collective_bytes_counts_dtensor_collectives_by_kind(production):
    """An all-reduce and an all-gather of a [64, 32] bf16 meta DTensor on
    16 x 16: each kind once, its result's bytes on one device."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.models.common import dt_zeros
    mesh = M.make_production_mesh()
    x = dt_zeros((64, 32), torch.bfloat16, mesh, (Replicate(), Partial()),
                 torch.device("meta"))
    y = dt_zeros((64, 32), torch.bfloat16, mesh, (Replicate(), Shard(0)),
                 torch.device("meta"))

    def step():
        x.redistribute(mesh, (Replicate(), Replicate()))
        y.redistribute(mesh, (Replicate(), Replicate()))
    got = dryrun.collective_bytes(step)
    assert got["counts"] == {"all-reduce": 1, "all-gather": 1,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    assert got["bytes"]["all-reduce"] == got["bytes"]["all-gather"] == (
        64 * 32 * 2)
    assert got["total_bytes"] == 2 * 64 * 32 * 2


def test_the_layout_options_place_their_constraints(production):
    """The reference's layout options that no shipped config turns on:
    an LM's ``seq_parallel`` (the residual stream's sequence over
    "model") and gatedgcn's ``shard_nodes`` (nodes over "model", edges
    over the data axes) each change the collectives of a production-mesh
    step, and the step still runs."""
    mesh = M.make_production_mesh()
    lm = _cut("qwen3-1.7b", 1)
    sp = dataclasses.replace(lm, cfg=dataclasses.replace(lm.cfg,
                                                         seq_parallel=True))
    base, split = (dryrun._costs(a, "prefill_32k", mesh)
                   for a in (lm, sp))
    assert split["collective_counts"] != base["collective_counts"]
    gnn = get_arch("gatedgcn")
    base, nodes = (dryrun._costs(a, "full_graph_sm", mesh) for a in (
        gnn, dataclasses.replace(gnn, shard_nodes=True)))
    assert nodes["collective_counts"] != base["collective_counts"]
