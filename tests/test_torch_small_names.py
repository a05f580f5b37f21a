"""The last small public names of the reference with a port counterpart:
``ShardedRelation.total``, the deprecated ``relation.counters_snapshot``
/ ``reset_counters`` shims over the registry and
``relops.expand_indices``, each against the JAX package's, and
``models.common.uniform_init``."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.engine import relation as JR
from repro.engine import relops as JO
from repro.engine import shard as JS
from repro_torch.engine import relation as R
from repro_torch.engine import relops as O
from repro_torch.engine import shard as S


def test_sharded_relation_total_is_the_live_rows_summed():
    rng = np.random.default_rng(0)
    blocks, ns = [], (5, 0, 11)
    for n in ns:
        rows = np.unique(rng.integers(0, 50, size=(n, 2)), axis=0)
        blocks.append(R.from_numpy(rows, 16, device="cpu"))
    got = S.ShardedRelation(blocks).total
    want = JS.ShardedRelation(
        data=jnp.zeros((3, 16, 2), jnp.int32), val=None,
        n=jnp.asarray([int(b.n) for b in blocks], jnp.int32)).total
    assert got.shape == () and int(got) == int(want) == sum(
        int(b.n) for b in blocks)


def test_counter_shims_read_and_zero_the_arrange_counters():
    R.reset_counters()
    JR.reset_counters()
    assert R.counters_snapshot() == JR.counters_snapshot() == dict.fromkeys(
        R.counters_snapshot(), 0)
    assert set(R.counters_snapshot()) == set(JR.counters_snapshot())
    R.COUNTERS["sorts"] = 3
    snap = R.counters_snapshot()
    assert snap["sorts"] == 3 and snap == dict(R.COUNTERS)
    snap["sorts"] = 7                       # a copy, not a view
    assert R.COUNTERS["sorts"] == 3
    R.reset_counters()
    assert not any(R.counters_snapshot().values())


def test_expand_indices_matches_the_reference():
    counts = np.array([2, 0, 3, 1], np.int32)
    offsets = np.cumsum(counts).astype(np.int32)
    got = O.expand_indices(torch.from_numpy(counts),
                           torch.from_numpy(offsets), 8)
    want = JO.expand_indices(jnp.asarray(counts), jnp.asarray(offsets), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_uniform_init_draws_in_the_scale_from_the_generator():
    from repro_torch.models.common import uniform_init
    draw = [uniform_init((64, 32), 0.25, torch.float32,
                         torch.Generator().manual_seed(3)) for _ in range(2)]
    assert draw[0].shape == (64, 32) and draw[0].dtype == torch.float32
    assert torch.equal(draw[0], draw[1])
    assert float(draw[0].abs().max()) <= 0.25
    assert float(draw[0].std()) > 0.1     # about 0.25 / sqrt(3)
