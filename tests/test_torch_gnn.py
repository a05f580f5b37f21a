"""The port's GNN path against the JAX package on the CPU: the segment
reduce's backward (sum, max, min) against ``jax.vjp`` of the reference's
``segment_reduce_ref``, ``gather``'s clipping, ``segment_softmax``,
``aggregate`` (against the reference's "xla" and Pallas "interpret"
routes), the four GNNs at their smoke configs (forward, every gradient
leaf, three AdamW train steps against the reference's jitted
``train_step``), the graph generators, the triplet join and the
neighbor sampler (arrays identical), and the launcher's crash and resume.

Tolerances (float32; XLA and torch add in other orders, so two runs of
the same function differ by a few float32 units of the largest term):
- segment reduce backward, gather, aggregate: exact or 1e-6 of scale (a
  sum's backward is a gather and a max's a share of one, so nothing is
  summed in another order but the aggregate itself);
- models: forward within 1e-5 of the output's largest value, every
  gradient leaf within 1e-4 of the leaf's largest value; train steps'
  loss and gnorm within 1e-5 relative, parameters within 1e-6 absolute
  (an Adam step moves a parameter by at most lr = 1e-3 times a
  bounded ratio, and these parameters are O(0.1 to 1)).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import sampler as JSa
from repro.data import synthetic as JS
from repro.kernels import ref as jref
from repro.launch import train as jax_train
from repro.models.gnn import common as JG
from repro.models.gnn import dimenet as JD
from repro.training import optim as JO
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.data import (
    NeighborSampler, random_geometric_graph, random_graph,
)
from repro_torch.engine.faults import (
    FaultPlan, FaultSpec, SimulatedCrash, install,
)
from repro_torch.kernels import segment_reduce as SR
from repro_torch.launch import train
from repro_torch.models import common as tc
from repro_torch.models.gnn import common as G
from repro_torch.models.gnn.dimenet import build_triplets
from repro_torch.training.optim import train_state_init, tree_leaves

GNN_ARCHS = ("gatedgcn", "gat-cora", "dimenet", "nequip")
SHAPE = "full_graph_sm"


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


def _close_to_scale(got, want, share, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=share * scale + 1e-30,
                               err_msg=what)


# -- the segment reduce's backward -------------------------------------------

def _segment_case(seed, n, d, num_segments):
    """Values from a few levels (ties in most segments), sorted ids with a
    head of negative ids, a tail past the end and empty segments."""
    rng = np.random.default_rng(seed)
    shape = (n,) if d == 0 else (n, d)
    vals = rng.integers(-3, 4, size=shape).astype(np.float32) * 0.5
    ids = np.sort(rng.integers(-2, num_segments + 2, n)).astype(np.int32)
    ids[(ids > 1) & (ids < 4)] = 5      # segments 2 and 3 empty
    ids = np.sort(ids)
    cot = rng.normal(size=(num_segments,) + shape[1:]).astype(np.float32)
    return vals, ids, cot


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("d", [0, 1, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_reduce_backward_matches_jax(op, d, seed):
    """The gradient JAX gives segment_sum / segment_max / segment_min:
    ties at the extreme share the gradient evenly, column by column;
    dropped ids (negative, past the end) get 0; empty segments pass
    nothing. The CPU route launches nothing."""
    vals, ids, cot = _segment_case(seed, 97, d, 9)
    want_out, vjp = jax.vjp(
        lambda v: jref.segment_reduce_ref(v, jnp.asarray(ids), 9, op),
        jnp.asarray(vals))
    (want,) = vjp(jnp.asarray(cot))
    v = torch.from_numpy(vals).requires_grad_()
    before = dict(SR.LAUNCHES)
    out = SR.segment_reduce(v, torch.from_numpy(ids), 9, op)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, v, torch.from_numpy(cot))
    np.testing.assert_array_equal(_np(out), np.asarray(want_out))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert SR.LAUNCHES == before


def test_segment_max_backward_splits_ties():
    """Values [1,3,3,2,5,5,5], ids [0,0,0,1,1,1,3], 3 segments, weights
    [1,10,100] on the finite maxima: [0, .5, .5, 0, 5, 5, 0]."""
    v = torch.tensor([1., 3, 3, 2, 5, 5, 5], requires_grad=True)
    ids = torch.tensor([0, 0, 0, 1, 1, 1, 3], dtype=torch.int32)
    out = SR.segment_reduce(v, ids, 3, "max")
    loss = (torch.where(torch.isfinite(out), out, 0.0)
            * torch.tensor([1., 10, 100])).sum()
    (g,) = torch.autograd.grad(loss, v)
    assert g.tolist() == [0, .5, .5, 0, 5, 5, 0]


def test_segment_max_backward_all_infinite_segment():
    """A segment whose values are all -inf keeps the initial value as a
    tie (JAX's rule): each of its k rows gets 1 / (k + 1)."""
    vals = np.array([1, -np.inf, -np.inf, 2], np.float32)
    ids = np.array([0, 1, 1, 2], np.int32)
    cot = np.array([1, 3, 5], np.float32)
    _, vjp = jax.vjp(lambda v: jref.segment_reduce_ref(
        v, jnp.asarray(ids), 3, "max"), jnp.asarray(vals))
    v = torch.from_numpy(vals).requires_grad_()
    (got,) = torch.autograd.grad(
        SR.segment_reduce(v, torch.from_numpy(ids), 3, "max"), v,
        torch.from_numpy(cot))
    np.testing.assert_allclose(_np(got), np.asarray(vjp(
        jnp.asarray(cot))[0]), rtol=1e-6)


def test_segment_reduce_without_grad_is_plain():
    vals, ids, _ = _segment_case(3, 40, 4, 6)
    v = torch.from_numpy(vals)
    for op in ("sum", "max", "min"):
        out = SR.segment_reduce(v, torch.from_numpy(ids), 6, op)
        assert out.grad_fn is None
        assert torch.equal(out, SR.segment_reduce_plain(
            v, torch.from_numpy(ids), 6, op))
    w = v.clone().requires_grad_()
    with torch.no_grad():
        assert SR.segment_reduce(w, torch.from_numpy(ids), 6).grad_fn is None
    assert SR.segment_reduce(w, torch.from_numpy(ids), 0).shape == (0, 4)


# -- the substrate -----------------------------------------------------------

def test_gather_clips():
    """Ids below 0 read row 0 and ids at or past n read row n - 1, as
    jnp.take(mode="clip"); the gradient goes to the clipped rows."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(7, 3)).astype(np.float32)
    idx = np.array([-3, 0, 6, 7, 12, 2, -1], np.int32)
    want = JG.gather(jnp.asarray(table), jnp.asarray(idx))
    t = torch.from_numpy(table).requires_grad_()
    got = G.gather(t, torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    cot = rng.normal(size=got.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: JG.gather(x, jnp.asarray(idx)),
                     jnp.asarray(table))
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(cot))
    np.testing.assert_allclose(_np(g), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-6, atol=1e-6)


def _softmax_case(seed, n_nodes=12, n_edges=60, heads=3):
    """Scores on a few levels (ties within receivers), receivers sorted
    with node 3 empty and a padded tail at the sacrificial node n - 1."""
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, n_nodes - 1, n_edges)).astype(np.int32)
    recv[recv == 3] = 4
    recv[-8:] = n_nodes - 1
    recv = np.sort(recv)
    scores = (rng.integers(-4, 5, (n_edges, heads)) * 0.25).astype(
        np.float32)
    scores[-8:] = 0.0                    # the padded edges' scores tie
    return scores, recv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_softmax_value_and_grad(seed):
    scores, recv = _softmax_case(seed)
    n = 12
    f = lambda s: JG.segment_softmax(s, jnp.asarray(recv), n)  # noqa: E731
    want, vjp = jax.vjp(f, jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = G.segment_softmax(s, torch.from_numpy(recv), n)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    cot = np.random.default_rng(seed + 10).normal(size=scores.shape).astype(
        np.float32)
    (g,) = torch.autograd.grad(got, s, torch.from_numpy(cot))
    (jg,) = vjp(jnp.asarray(cot))
    _close_to_scale(g, jg, 1e-6, "segment_softmax gradient")
    assert np.isfinite(_np(g)).all()


def test_segment_softmax_empty_node_is_zero():
    """A node with no in-edge has max -inf, taken as 0; its output rows
    (none) and every gradient stay finite."""
    scores, recv = _softmax_case(5)
    s = torch.from_numpy(scores).requires_grad_()
    smax = SR.segment_reduce(s, torch.from_numpy(recv), 12, "max")
    assert torch.isinf(smax[3]).all()
    out = G.segment_softmax(s, torch.from_numpy(recv), 12)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(s.grad).all()


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("op", ["sum", "max"])
def test_aggregate_matches_reference(backend, op):
    rng = np.random.default_rng(4)
    recv = np.sort(rng.integers(0, 16, 200)).astype(np.int32)
    msgs = rng.normal(size=(200, 70)).astype(np.float32)
    want = JG.aggregate(jnp.asarray(msgs), jnp.asarray(recv), 20, op,
                        backend=backend)
    got = G.aggregate(torch.from_numpy(msgs), torch.from_numpy(recv), 20, op)
    _close_to_scale(got, want, 1e-6, f"aggregate {op} {backend}")
    deg = G.degree(torch.from_numpy(recv), 20)
    np.testing.assert_array_equal(_np(deg), np.asarray(
        JG.degree(jnp.asarray(recv), 20, backend=backend)))


def test_arrange_by_receiver_is_stable():
    rng = np.random.default_rng(6)
    s = rng.integers(0, 9, 50).astype(np.int32)
    r = rng.integers(0, 9, 50).astype(np.int32)
    p = rng.normal(size=(50, 2)).astype(np.float32)
    want = JG.arrange_by_receiver(jnp.asarray(s), jnp.asarray(r),
                                  jnp.asarray(p), None)
    got = G.arrange_by_receiver(torch.from_numpy(s), torch.from_numpy(r),
                                torch.from_numpy(p), None)
    assert got[3] is None and want[3] is None
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_check_sorted_reads_once_a_version():
    ids = torch.tensor([0, 1, 1, 4], dtype=torch.int32)
    G.check_sorted(ids)
    assert ids._sorted_at_version == ids._version
    ids[0] = 7                                  # an in-place edit
    with pytest.raises(ValueError, match="sorted"):
        G.check_sorted(ids)
    with pytest.raises(ValueError, match="sorted"):
        G.check_sorted(torch.tensor([2, 1], dtype=torch.int32), "t_ji")


def test_batched_graph_specs_sizes():
    want = JG.batched_graph_specs(4, 30, 64, 16)
    got = G.batched_graph_specs(4, 30, 64, 16)
    assert set(got) == set(want)
    for k, (shape, _) in got.items():
        assert shape == want[k].shape


def test_layer_norm_matches_reference():
    from repro.models import common as jc
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(9, 70)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=70).astype(np.float32)
    b = rng.normal(size=70).astype(np.float32)
    want = jc.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = tc.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- the four models -----------------------------------------------------------

def _setup(name):
    """(reference arch, port arch, reference params, port model, reference
    batch, port batch) at the smoke config of full_graph_sm, the
    reference's weights carried over."""
    ra, pa = jax_arch(name), get_arch(name)
    jp, jcfg = ra.init_smoke(jax.random.PRNGKey(0), SHAPE)
    cfg = pa.config(SHAPE, True)
    assert tuple(cfg) == tuple(getattr(jcfg, f) for f in cfg._fields)
    tree = jax.tree.map(np.asarray, jp)
    model = pa.model_fn(cfg, G.params_from_numpy(tree, "cpu"), "cpu",
                        train=True)
    jb = next(jax_train.make_batches(ra, SHAPE, True))
    pb = next(train.make_batches(pa, SHAPE, True, "cpu"))
    return ra, pa, jp, jcfg, model, jb, pb


def _jax_loss(ra, jcfg, batch):
    """The reference's train_step loss (configs/base.py), as a function of
    the parameters: (loss, model output)."""
    from repro.models.common import cross_entropy_loss
    from repro.models.gnn import nequip as JN

    def loss(p):
        if ra.kind == "feature":
            g = JG.Graph(batch["senders"], batch["receivers"],
                         batch["node_feat"], batch.get("edge_feat"),
                         jnp.asarray(batch["node_feat"].shape[0]),
                         jnp.asarray(batch["senders"].shape[0]))
            out = ra.fwd_fn(p, jcfg, g)
            return cross_entropy_loss(out, batch["labels"]), out
        if ra.name == "dimenet":
            g = JD.GeoGraph(batch["positions"], batch["species"],
                            batch["senders"], batch["receivers"],
                            batch["t_kj"], batch["t_ji"])
        else:
            g = JN.GeoGraph(batch["positions"], batch["species"],
                            batch["senders"], batch["receivers"])
        out = ra.fwd_fn(p, jcfg, g)
        err = out - batch["energy_labels"]
        return jnp.mean(err * err), out
    return loss


def _port_graph(pa, batch):
    from repro_torch.models.gnn import dimenet, nequip
    if pa.kind == "feature":
        return G.Graph(batch["senders"], batch["receivers"],
                       batch["node_feat"], batch["edge_feat"],
                       batch["node_feat"].shape[0], batch["senders"].shape[0])
    if pa.name == "dimenet":
        return dimenet.GeoGraph(batch["positions"], batch["species"],
                                batch["senders"], batch["receivers"],
                                batch["t_kj"], batch["t_ji"])
    return nequip.GeoGraph(batch["positions"], batch["species"],
                           batch["senders"], batch["receivers"])


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_model_forward_and_gradients_match_reference(name):
    """The model's output within 1e-5 of its scale and every gradient leaf
    of the train loss within 1e-4 of the leaf's scale, against jax.grad
    of the reference's loss on the same weights and graph."""
    ra, pa, jp, jcfg, model, jb, pb = _setup(name)
    (jl, jout), jg = jax.jit(jax.value_and_grad(_jax_loss(ra, jcfg, jb),
                                                has_aux=True))(jp)
    out = model(_port_graph(pa, pb))
    _close_to_scale(out, jout, 1e-5, f"{name} forward")
    grads = model.grad_tree()
    state = train_state_init(model.param_tree())
    step = pa.step_fn(SHAPE, smoke=True)
    _, m = step(model, state, pb)
    np.testing.assert_allclose(_np(m["loss"]), np.asarray(jl), rtol=1e-5)
    got, want = tree_leaves(grads), jax.tree.leaves(jg)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        _close_to_scale(a, b, 1e-4, f"{name} gradient leaf {i}")


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_train_steps_match_reference(name):
    """Three AdamW steps against the reference's jitted train_step on the
    same weights and graph: loss and gnorm within 1e-5 relative, the
    parameters within 1e-6 after each step."""
    ra, pa, jp, jcfg, model, jb, pb = _setup(name)
    state = train_state_init(model.param_tree())
    jstate = JO.train_state_init(jp)
    jstep = jax.jit(ra.step_fn(SHAPE, smoke=True))
    step = pa.step_fn(SHAPE, smoke=True)
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        state, m = step(model, state, pb)
        assert set(m) == {"loss", "gnorm"}
        for k in m:
            np.testing.assert_allclose(_np(m[k]), np.asarray(jm[k]),
                                       rtol=1e-5, err_msg=k)
        for a, b in zip(tree_leaves(state.params),
                        jax.tree.leaves(jstate.params)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=1e-6)
        assert int(state.step) == int(jstate.step)
        assert state.params is model.param_tree()


def test_param_tree_and_grad_tree_share_the_modules_storage():
    """Layer i's parameters are layer i of the stacked tree; grad_tree's
    layer views are their .grad."""
    _, pa, _, _, model, _, pb = _setup("gatedgcn")
    tree = model.param_tree()
    assert model.stack[1]["A"].data_ptr() == tree["layers"]["A"][1].data_ptr()
    assert model.top["embed_h"].data_ptr() == tree["embed_h"].data_ptr()
    grads = model.grad_tree()
    assert model.stack[1]["B"].grad.data_ptr() == (
        grads["layers"]["B"][1].data_ptr())
    pa.step_fn(SHAPE, smoke=True)(model, train_state_init(tree), pb)
    assert float(grads["layers"]["B"][1].abs().sum()) > 0
    assert model.grad_tree() is grads
    assert float(grads["layers"]["B"].abs().sum()) == 0      # zeroed


def test_train_step_refusals():
    _, pa, _, _, model, _, pb = _setup("gat-cora")
    step = pa.step_fn(SHAPE, smoke=True)
    other = train_state_init(pa.init_fn(pa.config(SHAPE, True),
                                        torch.Generator().manual_seed(1)))
    with pytest.raises(ValueError, match="param_tree"):
        step(model, other, pb)
    with pytest.raises(ValueError, match="config"):
        pa.step_fn(SHAPE)(model, train_state_init(model.param_tree()), pb)
    unsorted = dict(pb, receivers=pb["receivers"].flip(0))
    with pytest.raises(ValueError, match="sorted"):
        step(model, train_state_init(model.param_tree()), unsorted)


def test_registry_resolves_every_reference_name():
    from repro.configs import ARCH_NAMES as JAX_NAMES
    assert set(ARCH_NAMES) == set(JAX_NAMES)
    for name in GNN_ARCHS:
        ra, pa = jax_arch(name), get_arch(name)
        assert pa.family == "gnn" and pa.kind == ra.kind
        for shape in pa.shapes:
            assert pa.model_flops(shape) == ra.model_flops(shape)
            want = {k: v.shape for k, v in ra.input_specs(shape).items()}
            assert pa.input_sizes(shape) == want
            want = {k: v.shape for k, v in ra.input_specs(
                shape, smoke=True).items()}
            assert pa.input_sizes(shape, smoke=True) == want


# -- data ------------------------------------------------------------------------

def _same_arrays(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("args", [(64, 256, 24, 8, 7, True),
                                  (300, 1000, 5, 16, 3, False),
                                  (2708, 10560, 16, 7, 11, True)])
def test_random_graph_identical(args):
    n, e, d, c, seed, pl = args
    _same_arrays(random_graph(n, e, d, n_classes=c, seed=seed, power_law=pl),
                 JS.random_graph(n, e, d, n_classes=c, seed=seed,
                                 power_law=pl))


@pytest.mark.parametrize("args", [(64, 5.0, 10.0, 7, 256),
                                  (20, 4.0, 6.0, 2, None),
                                  (500, 3.0, 10.0, 1, 2000)])
def test_random_geometric_graph_identical(args):
    n, cutoff, box, seed, max_edges = args
    _same_arrays(random_geometric_graph(n, cutoff, box, seed, max_edges),
                 JS.random_geometric_graph(n, cutoff, box, seed, max_edges))


@pytest.mark.parametrize("n,cap", [(20, 400), (64, 64), (200, 6000)])
def test_build_triplets_identical(n, cap):
    g = JS.random_geometric_graph(n, 4.0, 6.0, seed=n)
    got = build_triplets(g["senders"], g["receivers"], cap)
    want = JD.build_triplets(g["senders"], g["receivers"], cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_neighbor_sampler_identical(seed):
    g = JS.random_graph(500, 4000, 4, seed=seed)
    ours = NeighborSampler(g["senders"], g["receivers"], 500, (5, 3), seed)
    theirs = JSa.NeighborSampler(g["senders"], g["receivers"], 500, (5, 3),
                                 seed)
    assert ours.node_cap_per_seed == theirs.node_cap_per_seed
    assert ours.edge_cap_per_seed == theirs.edge_cap_per_seed
    rng = np.random.default_rng(seed)
    for _ in range(3):                  # the generator's state carries on
        seeds = rng.choice(500, 8, replace=False)
        _same_arrays(ours.sample(seeds), theirs.sample(seeds))


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_launcher_batches_identical(name):
    """The launcher's fixed graph (padded geometric edges and DimeNet's
    triplets included) equals the reference launcher's, re-yielded."""
    ra, pa = jax_arch(name), get_arch(name)
    want = next(jax_train.make_batches(ra, "molecule", True))
    batches = train.make_batches(pa, "molecule", True, "cpu")
    got = next(batches)
    _same_arrays({k: v.numpy() for k, v in got.items()}, want)
    assert next(batches) is got


# -- the launcher: depth cut, crash and resume --------------------------------

def test_launcher_cuts_gnn_depth():
    arch = train.cut_layers(get_arch("dimenet"), 1)
    assert arch.config("molecule").n_blocks == 1
    assert arch.config("molecule").d_hidden == 128
    arch = train.cut_layers(get_arch("gatedgcn"), 3)
    assert arch.config("minibatch_lg").n_layers == 3
    out = train.main(["--arch", "nequip", "--smoke", "--device", "cpu",
                      "--steps", "2", "--layers", "1", "--shape",
                      "molecule"])
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])
    with pytest.raises(ValueError, match="graph"):
        train.main(["--arch", "gatedgcn", "--smoke", "--device", "cpu",
                    "--batch", "2"])


def test_launcher_gnn_crash_and_resume_is_byte_equal(tmp_path):
    """gatedgcn, 6 steps with a checkpoint every 3: uninterrupted, and
    killed after step 4 then resumed with --resume; the final
    checkpoints are byte-equal."""
    common = ["--arch", "gatedgcn", "--smoke", "--device", "cpu",
              "--steps", "6", "--ckpt-every", "3", "--log-every", "100"]
    whole = train.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    plan = FaultPlan([FaultSpec("train.step", hit=5)])
    with install(plan), pytest.raises(SimulatedCrash):
        train.main(common + ["--ckpt-dir", str(tmp_path / "b")])
    for t in threading.enumerate():
        if t.name == CK.WRITER_THREAD:
            t.join()
    assert CK.latest_step(tmp_path / "b") == 3
    resumed = train.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--resume"])
    assert resumed["steps"] == 3
    assert resumed["last_loss"] == whole["last_loss"]
    ma, a = CK.load_checkpoint(tmp_path / "a", 6)
    mb, b = CK.load_checkpoint(tmp_path / "b", 6)
    assert ma == mb and set(a) == set(b)
    assert any("layers" in key for key in a)
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key
