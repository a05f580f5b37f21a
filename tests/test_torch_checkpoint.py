"""The port's checkpoint module (``repro_torch.checkpoint``) against the
JAX package's: a checkpoint written by either loads in the other with
equal leaf keys, arrays and manifests; the atomic publish, the cleanup
of a ``.tmp`` left by a crash, retention and the three fault sites
leave the same directories in both."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JC
from repro.engine import faults as JF
from repro_torch.checkpoint import checkpoint as TC
from repro_torch.engine import faults as TF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's many small torch ops on one thread: the test
    workers share the cores, and torch's idle OpenMP threads spinning on
    an oversubscribed host make such ops tens of times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _states(kind: str):
    """(state for the reference, the same state for the port): the
    reference's leaves are numpy or jax arrays, the port's tensors
    (numpy where the reference keeps numpy)."""
    rng = np.random.default_rng(len(kind))
    a = rng.integers(-9, 9, size=(5, 2)).astype(np.int32)
    b = rng.standard_normal(7).astype(np.float32)
    c = rng.integers(0, 1 << 40, size=3).astype(np.int64)
    if kind == "flat":                     # the resilience snapshot layout
        j = {"rows::tc": a, "val::tc": a[:, 0].copy(), "rows::edge": a[:0]}
        return j, {k: torch.from_numpy(v.copy()) for k, v in j.items()}
    if kind == "nested":
        j = {"w": {"b": b, "a": a}, "z": [c, (b[:2], a)], "skip": None}
        t = {"w": {"b": torch.from_numpy(b), "a": torch.from_numpy(a)},
             "z": [torch.from_numpy(c),
                   (torch.from_numpy(b[:2]), torch.from_numpy(a))],
             "skip": None}
        return j, t
    if kind == "bfloat16":
        j = {"w": jnp.asarray(b, dtype=jnp.bfloat16), "n": np.int64(3)}
        t = {"w": torch.from_numpy(b).to(torch.bfloat16), "n": np.int64(3)}
        return j, t
    if kind == "numpy":
        j = {"x": b, "y": {"0": c, "10": a, "9": np.bool_(True)}}
        return j, {k: v for k, v in j.items()}
    raise ValueError(kind)


KINDS = ("flat", "nested", "bfloat16", "numpy")


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, dtype=np.float32 if "bfloat16" in str(
        getattr(x, "dtype", "")) else None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_cross_loads(kind, writer, tmp_path):
    """Either package writes; both load: the same manifest (leaf keys,
    names, shapes, dtypes, extra) and the same arrays."""
    j_state, t_state = _states(kind)
    extra = {"program": "abc", "caps": {"idb_cap": 16}}
    if writer == "port":
        TC.save_checkpoint(tmp_path / "w", 3, t_state, extra=extra)
    else:
        JC.save_checkpoint(tmp_path / "w", 3, j_state, extra=extra)
    # the other package writes the same state beside it
    if writer == "port":
        JC.save_checkpoint(tmp_path / "o", 3, j_state, extra=extra)
    else:
        TC.save_checkpoint(tmp_path / "o", 3, t_state, extra=extra)
    for d in ("w", "o"):
        j_man, j_arrays = JC.load_checkpoint(tmp_path / d)
        t_man, t_arrays = TC.load_checkpoint(tmp_path / d)
        assert j_man == t_man == TC.read_manifest(tmp_path / d)
        assert list(j_arrays) == list(t_arrays)
        for key in j_arrays:
            np.testing.assert_array_equal(j_arrays[key], t_arrays[key])
            assert j_arrays[key].dtype == t_arrays[key].dtype
    written = json.loads((tmp_path / "w" / "step_00000003" /
                          "manifest.json").read_text())
    other = json.loads((tmp_path / "o" / "step_00000003" /
                        "manifest.json").read_text())
    assert written == other
    assert TC.all_steps(tmp_path / "w") == JC.all_steps(tmp_path / "w") == [3]


@pytest.mark.parametrize("kind", KINDS)
def test_restore_checkpoint_into_structure(kind, tmp_path):
    """restore_checkpoint rebuilds ``like``'s structure: tensors of its
    dtype from a reference checkpoint, equal to the reference's own
    restore."""
    j_state, t_state = _states(kind)
    JC.save_checkpoint(tmp_path, 1, j_state)
    j_out, j_step = JC.restore_checkpoint(tmp_path, j_state)
    t_out, t_step = TC.restore_checkpoint(tmp_path, t_state)
    assert j_step == t_step == 1
    j_leaves = TC._flatten_with_paths(
        {k: v for k, v in j_out.items()})
    t_leaves = TC._flatten_with_paths(t_out)
    assert [k for k, _ in j_leaves] == [k for k, _ in t_leaves]
    for (_, jv), (key, tv), (_, like) in zip(
            j_leaves, t_leaves, TC._flatten_with_paths(t_state)):
        assert type(tv) is type(like) or isinstance(like, np.generic)
        if isinstance(like, torch.Tensor):
            assert tv.dtype == like.dtype
        np.testing.assert_array_equal(_as_numpy(tv), _as_numpy(jv))
    with pytest.raises(KeyError, match="missing leaf"):
        TC.restore_checkpoint(tmp_path, {"absent": torch.zeros(2)})


def test_flatten_keys_match_jax():
    import jax
    j_state, _ = _states("nested")
    flat, _ = jax.tree_util.tree_flatten_with_path(j_state)
    want = ["/".join(str(p) for p in path) for path, _ in flat]
    assert [k for k, _ in TC._flatten_with_paths(j_state)] == want


def test_missing_checkpoint_raises(tmp_path):
    for fn in (TC.load_checkpoint, TC.read_manifest):
        with pytest.raises(FileNotFoundError):
            fn(tmp_path)
    assert TC.latest_step(tmp_path / "absent") is None


def _listing(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*"))


@pytest.mark.parametrize("site", ["checkpoint.write", "checkpoint.commit",
                                  "checkpoint.retention"])
def test_fault_sites_leave_the_same_directory(site, tmp_path):
    """A crash at each fault site of a third save (keep=2) leaves the
    same files in both packages: nothing published past a .tmp before
    the publish, the publish standing and retention undone after it;
    the next save clears the .tmp and applies retention."""
    j_state, t_state = _states("flat")
    runs = (("ref", JC, JF, j_state), ("port", TC, TF, t_state))
    for name, mod, faults, state in runs:
        d = tmp_path / name
        mod.save_checkpoint(d, 1, state, keep=2)
        mod.save_checkpoint(d, 2, state, keep=2)
        plan = faults.FaultPlan([faults.FaultSpec(site, kind="crash")])
        with faults.install(plan), pytest.raises(faults.SimulatedCrash):
            mod.save_checkpoint(d, 3, state, keep=2)
        assert plan.fired
    assert _listing(tmp_path / "ref") == _listing(tmp_path / "port")
    latest = TC.latest_step(tmp_path / "port")
    assert latest == (3 if site == "checkpoint.retention" else 2)
    assert ((tmp_path / "port" / "step_00000003.tmp").exists()
            == (site != "checkpoint.retention"))
    for name, mod, _, state in runs:
        mod.save_checkpoint(tmp_path / name, 4, state, keep=2)
    assert _listing(tmp_path / "ref") == _listing(tmp_path / "port")
    assert TC.all_steps(tmp_path / "port") == (
        [3, 4] if site == "checkpoint.retention" else [2, 4])
    assert not list((tmp_path / "port").glob("*.tmp"))


def test_atomic_publish_retention_and_resave(tmp_path):
    """Retention keeps the newest ``keep``; re-saving a published step
    is a no-op; a stale .tmp is invisible, then cleaned up."""
    _, state = _states("flat")
    (tmp_path / "step_00000009.tmp").mkdir(parents=True)
    assert TC.all_steps(tmp_path) == []
    for step in range(5):
        TC.save_checkpoint(tmp_path, step, state, keep=3)
    assert TC.all_steps(tmp_path) == [2, 3, 4]
    assert not (tmp_path / "step_00000009.tmp").exists()
    before = (tmp_path / "step_00000004" / "arrays.npz").read_bytes()
    changed = {k: v + 1 for k, v in state.items()}
    TC.save_checkpoint(tmp_path, 4, changed, keep=3)
    assert (tmp_path / "step_00000004" / "arrays.npz").read_bytes() == before


def test_pspecs_in_manifest(tmp_path):
    """Partition specs go into the manifest as strings, flattened as the
    reference flattens them (a tuple spec is a subtree)."""
    j_state, t_state = _states("flat")
    pspecs = {k: ("shards", None) for k in t_state}
    TC.save_checkpoint(tmp_path / "port", 0, t_state, pspecs=pspecs)
    JC.save_checkpoint(tmp_path / "ref", 0, j_state, pspecs=pspecs)
    man = TC.read_manifest(tmp_path / "port")
    assert man["pspecs"] == JC.read_manifest(tmp_path / "ref")["pspecs"]
    assert man["pspecs"] == {f"[{k!r}]/[0]": "shards"
                             for k in sorted(t_state)}


def test_checkpoint_manager_async(tmp_path):
    """save_async copies to the host before it returns: a later write to
    the tensor does not reach the checkpoint; wait() re-raises a failed
    write."""
    _, state = _states("nested")
    mgr = TC.CheckpointManager(tmp_path, keep=2)
    want = state["w"]["a"].clone()
    mgr.save_async(7, state)
    state["w"]["a"].add_(100)
    mgr.wait()
    assert mgr.latest_step() == 7
    out, _ = TC.restore_checkpoint(tmp_path, state)
    assert torch.equal(out["w"]["a"], want)
    plan = TF.FaultPlan([TF.FaultSpec("checkpoint.write", kind="io")])
    with TF.install(plan):
        mgr.save_async(8, state)
        with pytest.raises(TF.FaultError):
            mgr.wait()
    assert mgr.latest_step() == 7
