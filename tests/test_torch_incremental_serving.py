"""The port's serving entry point (``repro_torch.launch.incremental_serving``)
at the reference example's default size (examples/incremental_serving.py:
200 hosts, 30 update batches) on the CPU, unsharded and sharded: it
prints what the example prints, ending ``incremental_serving OK``, and
its final view equals the view a batch run of the reference engine
gives over the stream the example draws from the same seed."""
import numpy as np
import pytest
import torch

from repro.core.optimizer import compile_program as j_compile
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JConfig
from repro_torch.launch import incremental_serving as S


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's many small torch ops on one thread: the test
    workers share the cores, and torch's idle OpenMP threads spinning on
    an oversubscribed host make such ops tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference_final_view(updates=30, hosts=200) -> dict:
    """The example's stream, drawn as it draws it (seed 1; the present
    links sorted, as the EDB mirror holds them), then the reference's
    batch run over the final EDBs."""
    rng = np.random.default_rng(1)
    edbs = S.serving_edbs("random", hosts, 0, rng)
    links = {tuple(r) for r in edbs["link"]}
    for _ in range(updates):
        ins = rng.integers(0, hosts, size=(3, 2))
        cur = np.array(sorted(links))
        dele = cur[rng.permutation(len(cur))[:2]]
        links |= {tuple(r) for r in ins}
        links -= {tuple(r) for r in dele}
    out, _ = JEngine(j_compile(S.PROGRAM), JConfig(
        idb_cap=1 << 12, intermediate_cap=1 << 14,
        kernel_backend="jnp")).run({**edbs, "link": np.array(sorted(links))})
    return {k: np.asarray(out[k]) for k in ("reaches", "pathlen")}


@pytest.mark.parametrize("flags", [
    ["--durable"], [], ["--mode", "device", "--durable"],
    ["--shards", "2"]],
    ids=["durable", "plain", "device-durable", "sharded"])
def test_serving_matches_reference_example(flags, capsys, tmp_path):
    if flags and flags[-1] == "--durable":
        flags = flags + [str(tmp_path / "state")]
    out = S.main(["--device", "cpu"] + flags)
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("incremental_serving OK")
    assert "view=195 hosts, max hop count=7" in printed
    if "--durable" in flags:
        # the reference example's own summary at this size and seed
        assert ("resilience: 1 crash(es) absorbed, 5 update(s) replayed "
                "from the WAL, 4 snapshot(s), ladder rungs fired: "
                "{'capacity_backoff': 2, 'capacity_recovered': 1}"
                in printed)
    want = _reference_final_view()
    for rel in want:
        np.testing.assert_array_equal(out[rel], want[rel])


def test_serving_refuses_shards_by_name(capsys):
    """--shards N serves sharded (above); a negative count is refused by
    the option's name."""
    with pytest.raises(SystemExit):
        S.main(["--device", "cpu", "--shards", "-1"])
    assert "--shards" in capsys.readouterr().err


def test_serving_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.main(["--updates", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        S.main(["--updates", "1", "--durable"])


def test_kronecker_graph_serves():
    """--graph kronecker at a small scale: the view equals the port's
    host-mode batch run over the final EDBs."""
    from repro_torch.core.optimizer import compile_program
    from repro_torch.engine import Engine, EngineConfig
    out = S.main(["--device", "cpu", "--graph", "kronecker", "--scale",
                  "8", "--updates", "4", "--mode", "device"])
    rng = np.random.default_rng(1)
    edbs = S.serving_edbs("kronecker", 0, 8, rng)
    assert 0 < len(out["reaches"]) <= 256
    assert edbs["monitor"][0, 0] in out["reaches"][:, 0]
    assert not np.isin(edbs["quarantined"][:, 0],
                       np.setdiff1d(out["reaches"][:, 0],
                                    edbs["monitor"][:, 0])).any()
    batch, _ = Engine(compile_program(S.PROGRAM), EngineConfig(
        idb_cap=256, intermediate_cap=1 << 13, device="cpu")).run(
        {**edbs, "link": out["link"]})
    for rel in ("reaches", "pathlen"):
        np.testing.assert_array_equal(out[rel], batch[rel])
