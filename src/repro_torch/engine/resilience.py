"""Fault-tolerant engine state (the serving durability layer) — the
counterpart of ``repro.engine.resilience``, in the same on-disk format:
a snapshot or update log written by either package restores in the
other.

Wraps ``IncrementalEngine`` with durable snapshots, a write-ahead
update log, and a graceful maintenance degradation ladder, so a
maintained FlowLog fixpoint survives process death: a restarted node
resumes from ``latest snapshot + log replay`` instead of recomputing
from scratch. Deterministic fault injection (engine/faults.py) drives
the crash-replay differential (tests/test_torch_resilience.py).

Durability contract
===================

**What is fsync'd when.** ``DurableIncrementalEngine.apply`` appends
the update batch to the write-ahead log (one JSON record carrying a
monotone sequence number) and fsyncs it BEFORE any maintenance runs;
only then is the batch applied in memory. Snapshots are written with
the tmp-dir-then-``os.replace`` atomic publish of
``checkpoint/checkpoint.py`` — a crash mid-write leaves a ``.tmp``
directory that ``latest_step`` ignores and the next save removes, and
the log is compacted (records at or below the snapshot's
``applied_seq`` dropped, again via tmp + ``os.replace``) only AFTER
the snapshot has been published. At every instant, durable state =
newest published snapshot + every log record with a higher sequence
number.

**Crash windows and replay idempotence.** A crash before the log
append loses the un-acknowledged batch — correct, the caller never got
a result. A crash after the append (before, during, or after the
in-memory apply, including mid-snapshot) is absorbed by ``recover()``:
restore the newest snapshot, then re-apply logged records with
``seq > applied_seq`` in order. Replay is idempotent at the state
level because ``IncrementalEngine.apply`` filters inserts already in
the EDB mirror and deletes of absent rows — re-applying an
already-applied batch is a no-op — so a client that re-submits its
in-flight batch after a crash gets exactly-once apply semantics. A
torn log tail (partial last line from a crash mid-append) parses as
invalid JSON and truncates replay at the last complete record.

**Mismatch-refusal rules.** Every snapshot manifest carries a
``schema_version``, the program hash (over the compiled IR's
deterministic pretty-print + arities/EDBs/monoid table), the
``EngineConfig`` fingerprint (semiring), and the shard count
(``EngineConfig.shards``, 0 for one device). ``restore_snapshot``
refuses loudly (``SnapshotMismatch``) on any schema/program/semiring
mismatch, and with a ValueError on EDB values outside int32 (the EDB
mirror's limit). Rows are saved in host (gathered) form, so a snapshot
restores at any shard count, either package's: a shard count other
than the engine's re-homes every row through the target driver's
``_stored`` scatter (counted as ``resilience.restore.rehomed``).

**Degradation ladder.** Maintenance overflows escalate instead of
raising: (1) retry with capacity backoff — roll the in-memory state
back (``IncrementalEngine.rollback_point``), grow the engine's
*effective* caps (``EngineConfig`` is never mutated), and re-apply; (2)
stratum recompute fallback — re-base the EDBs (``apply_base``) and
recompute the affected strata from scratch; (3) full batch recompute
(``reinitialize``). Every rung is recorded as ``resilience.*`` counters
and spans on the attached observation.
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.checkpoint.checkpoint import (
    latest_step, load_checkpoint, save_checkpoint,
)
from repro_torch.core import ir as I
from repro_torch.engine import faults as F
from repro_torch.engine import observe as O
from repro_torch.engine.engine import EngineConfig, OverflowError_
from repro_torch.engine.incremental import IncrementalEngine
from repro_torch.engine.relation import (
    from_numpy, pow2_cap, to_numpy_with_val,
)

SCHEMA_VERSION = 1


class SnapshotMismatch(RuntimeError):
    """Snapshot is incompatible with the engine asked to restore it."""


# -- compatibility fingerprints ----------------------------------------------

def program_hash(compiled: I.CompiledProgram) -> str:
    """Stable hash of the compiled program's semantics-bearing parts:
    the deterministic IR pretty-print plus arities / EDB set / monoid
    table (which the pretty-print alone does not pin). The same program
    text hashes alike in both packages only when both parsed it from
    the same wildcard-counter state: ``_`` wildcards are named from a
    module-global counter (core/datalog/ast.py), so ``pretty()`` depends
    on what the process parsed before."""
    h = hashlib.sha256()
    h.update(compiled.pretty().encode())
    h.update(repr(sorted(compiled.arities.items())).encode())
    h.update(repr(sorted(compiled.edbs)).encode())
    h.update(repr(sorted(compiled.monoid_idbs.items())).encode())
    return h.hexdigest()[:16]


def config_fingerprint(cfg: EngineConfig) -> dict:
    """The config facts that change what stored state MEANS (restore
    refuses on these). Capacities, mode and device are representation
    and placement choices and deliberately excluded."""
    return {"semiring": cfg.semiring.name}


# -- durable snapshots --------------------------------------------------------

def _leaf_name(key: str) -> str:
    """checkpoint leaf key (str(DictKey) == \"['k']\") -> our key."""
    if key.startswith("['") and key.endswith("']"):
        return key[2:-2]
    return key


def save_snapshot(inc: IncrementalEngine, directory: str | Path,
                  seq: int, keep: int = 3) -> Path:
    """Atomically persist the maintained state at update sequence
    ``seq``: every stored full (gathered to host rows + monoid/diff
    values), the maintenance iteration counters, and the effective
    capacities, under a manifest carrying the compatibility record."""
    eng = inc.engine
    state: dict[str, np.ndarray] = {}
    rel_caps: dict[str, int] = {}
    for (name, ver), rel in sorted(inc._env.items()):
        if ver != I.FULL:
            continue
        host = eng._host_relation(rel)
        data, val = to_numpy_with_val(host)
        state[f"rows::{name}"] = np.asarray(data)
        if val is not None:
            state[f"val::{name}"] = np.asarray(val)
        rel_caps[name] = int(host.capacity)
    extra = {
        "schema_version": SCHEMA_VERSION,
        "program": program_hash(inc.compiled),
        "config": config_fingerprint(eng.cfg),
        "shards": int(eng.cfg.shards or 0),
        "applied_seq": int(seq),
        "caps": eng.effective_caps(),
        "iterations": {k: int(v)
                       for k, v in inc._stats.iterations.items()},
        "rel_caps": rel_caps,
    }
    return save_checkpoint(directory, seq, state, keep=keep,
                           extra=extra)


def _check_compat(inc: IncrementalEngine, extra: dict) -> None:
    if extra.get("schema_version") != SCHEMA_VERSION:
        raise SnapshotMismatch(
            f"snapshot schema_version {extra.get('schema_version')} != "
            f"engine schema_version {SCHEMA_VERSION}")
    want = program_hash(inc.compiled)
    if extra.get("program") != want:
        raise SnapshotMismatch(
            f"snapshot was taken from program {extra.get('program')}, "
            f"engine runs program {want} — refusing to restore")
    fp = config_fingerprint(inc.engine.cfg)
    if extra.get("config") != fp:
        raise SnapshotMismatch(
            f"snapshot config fingerprint {extra.get('config')} != "
            f"engine config fingerprint {fp} — refusing to restore")


def restore_snapshot(inc: IncrementalEngine, directory: str | Path,
                     step: Optional[int] = None) -> int:
    """Restore the newest (or ``step``) snapshot into ``inc``; returns
    the snapshot's ``applied_seq``. Refuses loudly on schema / program
    / semiring mismatch and on EDB values outside int32; a different
    shard count re-homes every row through the target driver's
    ``_stored`` scatter."""
    manifest, arrays = load_checkpoint(directory, step)
    extra = manifest.get("extra") or {}
    _check_compat(inc, extra)
    eng = inc.engine
    obs = eng.cfg.observe
    if int(extra.get("shards", 0)) != int(eng.cfg.shards or 0):
        O.count(obs, "resilience.restore.rehomed")
    by_name: dict[str, dict] = {}
    for key, arr in arrays.items():
        kind, _, name = _leaf_name(key).partition("::")
        by_name.setdefault(name, {})[kind] = arr
    # EDB mirror (host-side source of truth for apply diffs); first, so
    # a refused snapshot leaves the engine as it was
    inc.restore_mirror({name: by_name[name]["rows"]
                        for name in inc.compiled.edbs if name in by_name})
    host_rels = {}
    for name, parts in by_name.items():
        rows = parts["rows"]
        val = parts.get("val")
        cap = int(extra["rel_caps"].get(name, 0))
        cap = max(cap, pow2_cap(rows.shape[0]))
        sr = eng._sr_of(name)
        host_rels[name] = from_numpy(
            rows, cap, val=val,
            val_identity=(sr.identity if val is not None else None),
            dedupe=False, device=eng.device)
    stored = eng._stored(host_rels)
    inc._env = {(name, I.FULL): rel for name, rel in stored.items()}
    inc._stats.iterations = dict(extra.get("iterations", {}))
    eng.set_caps(extra.get("caps", {}))
    return int(extra["applied_seq"])


# -- write-ahead update log ---------------------------------------------------

def _rows_json(rows) -> list:
    arr = np.asarray(rows)
    if arr.size == 0:
        return []
    return arr.astype(int).reshape(len(arr), -1).tolist()


class UpdateLog:
    """Append-only fsync'd JSON-lines log of update batches.

    One record per ``append``: ``{"seq": n, "ins": {...}, "del":
    {...}}``. The write is flushed and fsync'd before ``append``
    returns, so a record either exists durably or the caller never got
    an acknowledgement. A torn tail (crash mid-write) fails JSON
    parsing and truncates ``records`` at the last complete line."""

    def __init__(self, path: str | Path, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self._fh = None

    def append(self, seq: int, inserts: Optional[dict],
               deletes: Optional[dict]) -> None:
        F.fault_point("wal.before_append")   # crash: batch never durable
        rec = {"seq": int(seq),
               "ins": {k: _rows_json(v)
                       for k, v in (inserts or {}).items()},
               "del": {k: _rows_json(v)
                       for k, v in (deletes or {}).items()}}
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        F.fault_point("wal.write")           # simulated IO failure
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        F.fault_point("wal.after_append")    # crash: logged, not applied

    def records(self, after_seq: int = -1) -> list[dict]:
        """Complete records with ``seq > after_seq``, in log order."""
        if not self.path.exists():
            return []
        out = []
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                if not line.endswith("\n"):
                    break                    # torn tail: crash mid-write
                try:
                    rec = json.loads(line)
                except ValueError:
                    break
                if int(rec["seq"]) > after_seq:
                    out.append(rec)
        return out

    def compact(self, through_seq: int) -> None:
        """Drop records with ``seq <= through_seq`` (they are covered
        by a published snapshot) via tmp + atomic replace."""
        keep = self.records(after_seq=through_seq)
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w", encoding="utf-8") as fh:
            for rec in keep:
                fh.write(json.dumps(rec) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        self.close()                         # old inode: reopen lazily
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# -- the durable engine -------------------------------------------------------

@dataclass
class ResilienceConfig:
    # auto-snapshot every N applied updates (0 = only on initialize /
    # explicit checkpoint())
    snapshot_every: int = 0
    keep: int = 3                 # snapshot retention
    max_capacity_retries: int = 4  # ladder rung 1 attempts
    growth_factor: int = 2
    fsync: bool = True


class DurableIncrementalEngine:
    """``IncrementalEngine`` + durability: WAL-before-apply, periodic
    atomic snapshots, crash recovery via ``recover()``, and the
    graceful degradation ladder around every maintenance pass."""

    def __init__(self, compiled: I.CompiledProgram,
                 config: EngineConfig | None = None,
                 directory: str | Path = "flowlog_state",
                 resilience: ResilienceConfig | None = None):
        self.compiled = compiled
        self.inc = IncrementalEngine(compiled, config)
        self.rcfg = resilience or ResilienceConfig()
        self.directory = Path(directory)
        self.snap_dir = self.directory / "snapshots"
        self.log = UpdateLog(self.directory / "updates.log",
                             fsync=self.rcfg.fsync)
        self.applied_seq = -1

    @property
    def engine(self):
        return self.inc.engine

    @property
    def _obs(self):
        return self.inc.engine.cfg.observe

    def snapshot(self) -> dict[str, np.ndarray]:
        return self.inc.snapshot()

    def close(self) -> None:
        self.log.close()

    # -- lifecycle ------------------------------------------------------------
    def recoverable(self) -> bool:
        """Is there durable state to recover from?"""
        return latest_step(self.snap_dir) is not None

    def initialize(self, edbs: dict) -> dict[str, np.ndarray]:
        """Batch-compute the fixpoint and immediately persist it as
        snapshot 0, so every later crash recovers without a full
        recompute."""
        out = self.inc.initialize(edbs)
        self.applied_seq = 0
        self.checkpoint()
        return out

    def recover(self, step: Optional[int] = None) -> dict[str, np.ndarray]:
        """Restart path: newest snapshot + replay of logged updates
        with higher sequence numbers. Returns the recovered state."""
        obs = self._obs
        with O.span(obs, "resilience-recover"):
            seq = restore_snapshot(self.inc, self.snap_dir, step)
            self.applied_seq = seq
            replayed = 0
            for rec in self.log.records(after_seq=seq):
                self._apply_ladder(rec["ins"], rec["del"])
                self.applied_seq = int(rec["seq"])
                replayed += 1
            O.count(obs, "resilience.replayed_updates", replayed)
        return self.inc.snapshot()

    def checkpoint(self) -> Path:
        """Persist a snapshot at the current sequence, then compact the
        log (snapshot first: durable state is never less than snapshot
        + remaining log)."""
        with O.span(self._obs, "resilience-snapshot",
                    seq=self.applied_seq):
            path = save_snapshot(self.inc, self.snap_dir,
                                 self.applied_seq, keep=self.rcfg.keep)
            self.log.compact(self.applied_seq)
        O.count(self._obs, "resilience.snapshots")
        return path

    # -- the durable apply ----------------------------------------------------
    def apply(self, inserts: Optional[dict] = None,
              deletes: Optional[dict] = None) -> dict[str, np.ndarray]:
        seq = self.applied_seq + 1
        with O.span(self._obs, "durable-apply", seq=seq):
            self.log.append(seq, inserts, deletes)
            F.fault_point("resilience.after_log")
            out = self._apply_ladder(inserts, deletes)
            self.applied_seq = seq
        if (self.rcfg.snapshot_every
                and seq % self.rcfg.snapshot_every == 0):
            self.checkpoint()
        return out

    # -- degradation ladder ---------------------------------------------------
    def _apply_ladder(self, inserts, deletes) -> dict[str, np.ndarray]:
        """Maintenance with escalation instead of failure: capacity
        backoff -> stratum recompute -> full batch recompute. Only
        ``OverflowError_`` escalates; injected crashes and IO faults
        propagate like the real thing."""
        inc = self.inc
        obs = self._obs
        rcfg = self.rcfg
        for attempt in range(rcfg.max_capacity_retries + 1):
            point = inc.rollback_point()
            try:
                out = inc.apply(inserts, deletes)
                if attempt:
                    O.count(obs, "resilience.ladder.capacity_recovered")
                return out
            except OverflowError_ as err:
                inc.rollback(point)
                if attempt >= rcfg.max_capacity_retries:
                    break
                grown = inc.engine.grow_caps(rcfg.growth_factor)
                O.count(obs, "resilience.ladder.capacity_backoff")
                if obs is not None:
                    obs.event("capacity-backoff", attempt=attempt + 1,
                              error=str(err), **{
                                  k: v for k, v in grown.items()
                                  if k != "idb_caps"})
        # rung 2: re-base the EDBs, recompute affected strata
        O.count(obs, "resilience.ladder.stratum_recompute")
        with O.span(obs, "resilience-rung", rung="stratum-recompute"):
            try:
                changed = inc.apply_base(inserts, deletes)
                inc.recompute_strata(changed)
                return inc.snapshot()
            except OverflowError_:
                pass
        # rung 3: full batch recompute (apply_base is idempotent, so
        # re-basing after rung 2's partial failure is a no-op)
        O.count(obs, "resilience.ladder.full_recompute")
        with O.span(obs, "resilience-rung", rung="full-recompute"):
            inc.apply_base(inserts, deletes)
            inc.reinitialize()
            return inc.snapshot()
