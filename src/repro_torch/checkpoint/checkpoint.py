"""Fault-tolerant checkpoints — the counterpart of
``repro.checkpoint.checkpoint``, byte-compatible with it: a checkpoint
written by either package loads in the other.

Layout: ``<dir>/step_XXXXXXXX/`` holds ``arrays.npz`` (leaves named
``arr_<i>``) and ``manifest.json`` (``{"step", "leaves": [{"key",
"name", "shape", "dtype"}], "extra"}``).

* **Atomicity** — written into ``step_XXXXXXXX.tmp`` and published by
  ``os.replace`` (an atomic rename); a crash mid-write leaves a ``.tmp``
  directory that ``all_steps`` ignores and the next save removes.
* **Retention** — the newest ``keep`` checkpoints stay.
* **Leaf keys** — a state is a tree of dicts, lists and tuples whose
  leaves are numpy arrays, tensors or scalars. It is flattened as
  ``jax.tree_util.tree_flatten_with_path`` flattens it: dict keys
  sorted, a dict key rendered ``['k']``, a list index ``[i]``, a
  NamedTuple field ``.name`` (a ``TrainState``'s ``.params``, ``.step``),
  path parts joined by ``/``, ``None`` an empty subtree. Tensors are copied to the
  host before the write; bfloat16 is stored as float32 (npz has no
  bfloat16) under its own dtype name.
* **Fault sites** ``checkpoint.write`` / ``.commit`` / ``.retention``
  (engine/faults.py): before the write, between the write and the
  publish, and after the publish.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.engine.faults import fault_point


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(key, leaf)] in JAX's flatten order and key rendering."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        parts = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        parts = [(f".{name}", v) for name, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        parts = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for part, sub in parts:
        out += _flatten_with_paths(sub, f"{prefix}/{part}" if prefix
                                   else part)
    return out


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from leaves in flatten order."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array to store, and the dtype name to record."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.float().numpy(), "bfloat16"
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    dtype_str = str(arr.dtype)
    if arr.dtype.kind == "V" or "bfloat16" in dtype_str:
        arr = arr.astype(np.float32)     # npz can't store bf16
    return arr, dtype_str


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    pspecs: Any = None, keep: int = 3,
                    extra: Optional[dict] = None) -> Path:
    """Write ``state`` as checkpoint ``step`` and publish it atomically.
    ``pspecs`` (a tree of partition specs, stored as strings) and
    ``extra`` (any JSON-serializable dict; the resilience layer's
    compatibility record) go into the manifest."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    # a crash mid-write leaves a stale step_XXXX.tmp behind; it is
    # invisible to all_steps/latest_step, and cleaned up here
    for d in directory.iterdir():
        if d.is_dir() and d.name.endswith(".tmp"):
            _rmtree(d)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if final.exists():
        return final                             # idempotent re-save
    tmp.mkdir(exist_ok=True)

    arrays = {}
    manifest = {"step": step, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(state)):
        name = f"arr_{i}"
        arr, dtype_str = _host_array(leaf)
        arrays[name] = arr
        manifest["leaves"].append(
            {"key": key, "name": name, "shape": list(arr.shape),
             "dtype": dtype_str})
    if pspecs is not None:
        manifest["pspecs"] = {k: str(v)
                              for k, v in _flatten_with_paths(pspecs)}
    if extra is not None:
        manifest["extra"] = extra
    fault_point("checkpoint.write")
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    fault_point("checkpoint.commit")             # crash: tmp left behind
    os.replace(tmp, final)                       # atomic publish
    fault_point("checkpoint.retention")          # crash: publish stands

    # retention (never deletes the one just written)
    for s in all_steps(directory)[:-keep]:
        _rmtree(directory / f"step_{s:08d}")
    return final


def _rmtree(p: Path):
    if not p.exists():
        return
    for f in p.iterdir():
        f.unlink()
    p.rmdir()


def all_steps(directory: str | Path) -> list[int]:
    directory = Path(directory)
    out = []
    if not directory.exists():
        return out
    for d in directory.iterdir():
        if d.is_dir() and d.name.startswith("step_") and not (
                d.name.endswith(".tmp")):
            if (d / "manifest.json").exists():
                out.append(int(d.name[5:]))
    return sorted(out)


def latest_step(directory: str | Path) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _step_dir(directory: str | Path, step: Optional[int]) -> Path:
    directory = Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return directory / f"step_{step:08d}"


def read_manifest(directory: str | Path,
                  step: Optional[int] = None) -> dict:
    """Manifest of one checkpoint (latest by default)."""
    return json.loads(
        (_step_dir(directory, step) / "manifest.json").read_text())


def load_checkpoint(directory: str | Path,
                    step: Optional[int] = None) -> tuple[dict, dict]:
    """Raw load without a ``like`` structure: (manifest, {leaf key ->
    numpy array}). The resilience layer uses this: its snapshot layout
    is keyed by relation name."""
    d = _step_dir(directory, step)
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        out = {leaf["key"]: arrays[leaf["name"]]
               for leaf in manifest["leaves"]}
    return manifest, out


def restore_checkpoint(directory: str | Path, like: Any,
                       step: Optional[int] = None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` -> (state, step). A tensor
    leaf of ``like`` comes back as a tensor of its dtype on its device;
    any other leaf as a numpy array of its dtype (or the stored one)."""
    manifest, arrays = load_checkpoint(directory, step)
    leaves = []
    for key, leaf in _flatten_with_paths(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(np.array(arr))   # keeps a 0-d leaf 0-d
            leaves.append(t.to(device=leaf.device, dtype=leaf.dtype))
            continue
        want = np.dtype(leaf.dtype if hasattr(leaf, "dtype")
                        else arr.dtype)
        leaves.append(arr.astype(want) if arr.dtype != want else arr)
    return _unflatten(like, iter(leaves)), int(manifest["step"])


WRITER_THREAD = "checkpoint-writer"


class CheckpointManager:
    """Async writer with a single background thread (a save waits only
    if the previous one is still writing). The state is copied to the
    host before ``save_async`` returns."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, state: Any, pspecs: Any = None):
        self.wait()
        host_state = _unflatten(
            state, iter(_host_leaf(leaf)
                        for _, leaf in _flatten_with_paths(state)))

        def work():
            try:
                save_checkpoint(self.directory, step, host_state,
                                pspecs, self.keep)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True,
                                        name=WRITER_THREAD)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self):
        return latest_step(self.directory)


def _host_leaf(leaf):
    """A snapshot of a leaf that later device writes cannot change."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)
