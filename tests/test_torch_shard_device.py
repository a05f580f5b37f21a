"""The port's sharded engine in device mode, on the CPU, against the JAX
Engine's ``mode="device"`` (unsharded: the reference's contract makes its
sharded loop byte-identical to it): facts, dtypes, per-stratum
iterations and the empty delta logs over the corpus plus CC and SSSP at
1, 2, 4 and 8 shards; the loop's contract under shards (one iteration on
an empty EDB, a quiet stop at ``max_iters`` with the reference's partial
fixpoint, where host mode raises); force_multiword(); and an overflow
that grows and matches. A file of its own, so a parallel run can give it
to another worker than ``tests/test_torch_shard.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core.optimizer import compile_program as t_compile
from repro_torch.engine import EngineConfig as TConfig
from repro_torch.engine.shard import ShardedEngine

from test_torch_device_mode import _case, reference
from test_torch_engine import CAPS, datasets

SHARD_COUNTS = (1, 2, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_matches(program: str, shards: int, variant: str = "plain",
                   multiword: bool = False, **caps):
    want, want_iters, want_log = reference(program, variant, multiword)
    src, edbs, extra = _case(program, variant)
    engine = ShardedEngine(t_compile(src), TConfig(
        device="cpu", mode="device", shards=shards,
        **{**CAPS, **caps}, **extra))
    try:
        if multiword:
            from repro_torch.engine.relation import force_multiword
            with force_multiword():
                out, stats = engine.run(edbs)
        else:
            out, stats = engine.run(edbs)
    finally:
        engine.close()
    assert out.keys() == want.keys()
    for name in want:
        assert out[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(out[name], want[name], err_msg=name)
    assert stats.iterations == want_iters
    assert stats.delta_sizes == want_log
    return stats


@pytest.mark.parametrize("shards", SHARD_COUNTS)
@pytest.mark.parametrize("program", sorted(datasets()))
def test_sharded_device_mode_matches_reference(program, shards):
    assert assert_matches(program, shards).grow_retries == 0


@pytest.mark.parametrize("shards", (2, 4))
def test_loop_contract_under_shards(shards):
    """At least one iteration (an empty EDB runs one, where host mode
    runs none), and at max_iters a quiet stop with the reference's
    partial fixpoint; host mode raises there."""
    assert assert_matches("TC", shards, "empty").iterations == {"s0": 1}
    stats = assert_matches("TC", shards, "max_iters=2")
    assert stats.iterations == {"s0": 2}
    src, edbs, _ = _case("TC", "plain")
    engine = ShardedEngine(t_compile(src), TConfig(
        device="cpu", shards=shards, max_iters=2, **CAPS))
    with pytest.raises(RuntimeError, match="no fixpoint"):
        engine.run(edbs)
    engine.close()


def test_force_multiword_and_overflow_under_shards():
    """Every key two words (the multi-word probe path) at 2 shards; caps
    far below the fixpoint's grow and still match at 4."""
    assert_matches("WideReach", 2, multiword=True)
    stats = assert_matches("TC", 4, idb_cap=1 << 6, intermediate_cap=1 << 7)
    assert stats.grow_retries >= 2
