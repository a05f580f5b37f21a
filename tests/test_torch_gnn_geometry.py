"""The port's O(3) machinery (repro_torch.models.gnn.geometry) against the
JAX package's: the Clebsch-Gordan tables and Wigner matrices (numpy
float64, the same derivation: equal to 1e-12), the spherical harmonics,
the radial and angular bases (float32, 1e-6), padded zero-length edges
kept finite, and NequIP's E(3) invariance, mirroring
tests/test_gnn_properties.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import random_geometric_graph
from repro.models.gnn import geometry as JG
from repro.models.gnn import nequip as JN
from repro_torch.models.gnn import geometry as G
from repro_torch.models.gnn import nequip as N
from repro_torch.models.gnn.common import params_from_numpy
from repro_torch.training.optim import tree_leaves

TRIPLES = [(a, b, c) for a in range(3) for b in range(3) for c in range(3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("l1,l2,l3", TRIPLES)
def test_cg_tables_equal_reference(l1, l2, l3):
    """Every path up to l_max = 2 (and every missing one) as the
    reference's, to 1e-12, the sign convention included; unit norm."""
    got, want = G.cg(l1, l2, l3), JG.cg(l1, l2, l3)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert abs(np.linalg.norm(got) - 1.0) < 1e-12


def test_paths_and_wigner_equal_reference():
    assert G.tensor_product_paths(2) == [p for p, _ in
                                         JG.tensor_product_paths(2)]
    rng = np.random.default_rng(3)
    for l in range(3):
        R = G._rand_rotation(rng)
        np.testing.assert_allclose(G.wigner(l, R), JG.wigner(l, R), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(G._sample_points(), JG._sample_points())


@pytest.mark.parametrize("l", [0, 1, 2])
def test_real_sph_harm_matches_reference(l):
    rng = np.random.default_rng(l)
    r = rng.normal(size=(50, 3)).astype(np.float32)
    r[0] = 0.0                                  # a padded edge
    want = JG.real_sph_harm(l, jnp.asarray(r))
    got = G.real_sph_harm(l, torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert torch.isfinite(got).all()
    r64 = rng.normal(size=(20, 3))
    np.testing.assert_array_equal(G.real_sph_harm_np(l, r64),
                                  JG.real_sph_harm(l, r64, np))


def test_bessel_rbf_and_angular_basis_match_reference():
    rng = np.random.default_rng(0)
    d = rng.uniform(0, 6, 200).astype(np.float32)
    d[:3] = [0.0, 1e-9, 5.0]                    # zero, tiny, at the cutoff
    want = JG.bessel_rbf(jnp.asarray(d), 8, 5.0)
    got = G.bessel_rbf(torch.from_numpy(d), 8, 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert torch.isfinite(got).all()
    c = rng.uniform(-1, 1, 100).astype(np.float32)
    np.testing.assert_allclose(
        G.angular_basis(torch.from_numpy(c), 7).numpy(),
        np.asarray(JG.angular_basis(jnp.asarray(c), 7)), rtol=1e-6,
        atol=1e-6)


def _nequip(cfg, train=False):
    params = JN.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    return N.NequIP(N.NequIPConfig(*cfg[:-1]), params_from_numpy(
        tree, "cpu"), device="cpu", train=train), params


def _graph(pos, g):
    return N.GeoGraph(torch.from_numpy(np.asarray(pos, np.float32)),
                      torch.from_numpy(g["species"]),
                      torch.from_numpy(g["senders"]),
                      torch.from_numpy(g["receivers"]))


def test_nequip_rotation_invariant_energy():
    """The energy is invariant under a rotation and translation of the
    positions (the reference's test, on the port)."""
    cfg = JN.NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4,
                          cutoff=4.0)
    model, _ = _nequip(cfg)
    g = random_geometric_graph(20, cutoff=4.0, box=6.0, seed=2)
    e0 = model(_graph(g["positions"], g))
    rng = np.random.default_rng(5)
    R = G._rand_rotation(rng)
    t = rng.normal(size=3) * 2
    e1 = model(_graph(g["positions"] @ R.T + t, g))
    np.testing.assert_allclose(e0.detach().numpy(), e1.detach().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_nequip_padded_edges_stay_finite():
    """Padded edges (sender = receiver = the last node, a zero edge
    vector) give finite energies and gradients; positions take none."""
    cfg = JN.NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4,
                          cutoff=4.0)
    model, params = _nequip(cfg, train=True)
    g = random_geometric_graph(20, cutoff=4.0, box=6.0, seed=2)
    pad = 16
    g = dict(g, senders=np.concatenate([g["senders"], np.full(pad, 19,
                                                              np.int32)]),
             receivers=np.concatenate([g["receivers"],
                                       np.full(pad, 19, np.int32)]))
    graph = _graph(g["positions"], g)
    grads = model.grad_tree()
    energy = model(graph)
    energy.sum().backward()
    assert torch.isfinite(energy).all()
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    assert graph.positions.grad is None
    want = JN.forward(params, cfg, JN.GeoGraph(
        jnp.asarray(g["positions"]), jnp.asarray(g["species"]),
        jnp.asarray(g["senders"]), jnp.asarray(g["receivers"])))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(energy.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5 * scale)
