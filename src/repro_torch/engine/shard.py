"""Sharded fixpoint execution — hash-partitioned semi-naive evaluation,
the counterpart of ``repro.engine.shard``.

Design
======

**Partition invariant.** A ``ShardedRelation`` is the engine's sorted
arrangement ``Relation`` hash-partitioned across a 1-D shard mesh
(``launch.mesh.make_shard_mesh``): one block a shard, on that shard's
device, and **every block is itself a valid Relation** — rows ``[0, n)``
live, sorted, distinct, PAD tail — at the global capacity, as the
reference's stacked blocks are. All shard-local relops therefore apply
unchanged, kernel dispatch included.

Rows are placed by an FNV-1a hash of selected columns (``shard_of``, in
int64: wrapping multiplies and xors give uint64's bits, so the placement
is the reference's row for row). Materialized relations live on their
**home** shard, the hash of the full row, so equal rows co-locate and
the fixpoint's duplicate- and value-combining steps are shard-local.

**Repartitioning.** Binary ops keyed on a column subset (join,
semijoin/antijoin, grouped reduce) first repartition their operands on
the operation key with a padded-bucket all-to-all (``repartition_rows``):
each shard buckets its rows by destination into an ``[S, cap]`` send
buffer, the group swaps buckets, and a shard-local ``dedupe`` re-sorts
the received rows. Derived rows are re-homed by their full row before
they merge into an IDB (``ShardedEngine._merge_head``), so the sharded
delta is exactly the single-device delta, shard by shard. The per-pass
``ArrangementCache`` memoizes repartitions by operand identity.

**One controller, one thread a shard.** The reference runs its shard
bodies under one ``shard_map``. Here the controlling thread drives the
stratum as ``Engine`` does, and every shard-local step (``_stratum_init``,
``_stratum_seed``, ``_stratum_iter``, ``_rule_pass_body``, the relops)
runs as the engine's own code, once per shard, on a ``ShardGroup``: one
daemon worker thread a shard, started with the engine and stopped with
it. The group's collectives (the all-to-all, the sums of the zero-key
guard and of device mode's termination test) stay on the device: a
shard deposits its tensors, waits at the group's barrier and reads the
others'. Shards on one device share the controller's current stream, so
launch order behind the barrier orders every exchange, and they take
turns on the device between collectives, so one shard's temporaries are
freed before the next's are allocated (running them at once only
multiplied the peak memory); across devices a reader waits for the
writer's event. An exception in one shard aborts
the barrier, every other shard's body returns, and the controller
re-raises it. Each shard has its own evaluator (an ``ArrangementCache``
is per-pass state keyed by identity), the kernels count their launches
under a lock, and shards 1 to S - 1 record no spans and count nothing
(``observe.mute``): the reference traces one shard body, so spans and
counters are shard 0's.

**Fixpoint driver.** ``ShardedEngine`` mirrors ``Engine._run_stratum``:

* ``host`` mode — one round of shard steps per iteration; the controller
  reads the overflow flags and every shard's delta counts together.
* ``device`` mode — the reference's sharded ``while_loop``: each
  iteration folds the group's sums of delta rows and overflow flags into
  a three-word log [any_delta, overflow, iterations] that the controller
  reads once; it runs at least one iteration and stops quietly at
  ``max_iters``. The shard bodies run eagerly: a sharded iteration is
  not captured as a CUDA graph.

Fault points stay on the controlling thread (``engine.stratum``,
``engine.rule_pass``), so one ``FaultPlan`` works at any shard count.
``ShardedEngine`` gives byte-identical fixpoints and iteration counts to
``Engine`` at every shard count (tests/test_torch_shard.py).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import weakref
from typing import Optional

import torch

from repro_torch.core import ir as I
from repro_torch.engine import faults as F
from repro_torch.engine import observe as O
from repro_torch.engine import relops as R
from repro_torch.engine.engine import Engine, EngineConfig, OverflowError_
from repro_torch.engine.lower import Evaluator, LowerConfig
from repro_torch.engine.observe import trace_count
from repro_torch.engine.relation import (
    PAD, Relation, _stable_lex_perm, live_mask, pow2_cap,
)
from repro_torch.engine.semiring import Semiring
from repro_torch.launch.mesh import SHARD_AXIS, make_shard_mesh

# FNV-1a's 64-bit offset basis as int64 bits, and its prime
_FNV_OFFSET = 14695981039346656037 - (1 << 64)
_FNV_PRIME = 1099511628211

# the shard a worker thread runs: its rank and device
_LOCAL = threading.local()


class ShardedRelation:
    """A Relation hash-partitioned across the shard mesh: one block a
    shard, each a valid Relation on its own (sorted, distinct, PAD tail)
    at the global capacity. ``data[s]``, ``val[s]`` and ``n[s]`` are
    shard s's."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = tuple(blocks)

    @property
    def num_shards(self) -> int:
        return len(self.blocks)

    @property
    def capacity(self) -> int:
        return self.blocks[0].capacity

    @property
    def arity(self) -> int:
        return self.blocks[0].arity

    @property
    def data(self) -> tuple:
        return tuple(b.data for b in self.blocks)

    @property
    def val(self) -> Optional[tuple]:
        if self.blocks[0].val is None:
            return None
        return tuple(b.val for b in self.blocks)

    @property
    def n(self) -> tuple:
        return tuple(b.n for b in self.blocks)

    @property
    def total(self) -> torch.Tensor:
        """The live rows of every shard, summed (0-d int64, on shard
        0's device)."""
        dev = self.blocks[0].n.device
        return torch.stack([b.n.to(dev) for b in self.blocks]).sum()

    def __repr__(self):
        return (f"ShardedRelation(shards={self.num_shards}, "
                f"cap={self.capacity}, arity={self.arity})")


def _local(tree, rank: int):
    """Shard ``rank``'s view of an environment, state or tuple: each
    ShardedRelation becomes its block. A plain Relation is refused: the
    sharded driver's inputs are in stored form (``_stored``)."""
    if isinstance(tree, ShardedRelation):
        return tree.blocks[rank]
    if isinstance(tree, Relation):
        raise TypeError("a plain Relation reached a sharded step; pass "
                        "it through ShardedEngine._stored first")
    if isinstance(tree, dict):
        return {k: _local(v, rank) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_local(v, rank) for v in tree)
    return tree


def _rank() -> int:
    return _LOCAL.rank


# -- hash partitioning -------------------------------------------------------

def _row_hash(data: torch.Tensor, cols: tuple[int, ...]) -> torch.Tensor:
    """FNV-1a over the selected columns, in int64 (the reference's uint64
    bits). Columns widen to int64 by sign extension, as ``astype``
    does; any arity."""
    h = torch.full((data.shape[0],), _FNV_OFFSET, dtype=torch.int64,
                   device=data.device)
    for c in cols:
        h = (h ^ data[:, c].to(torch.int64)) * _FNV_PRIME
    return h


def shard_of(data: torch.Tensor, cols: tuple[int, ...], live: torch.Tensor,
             num_shards: int) -> torch.Tensor:
    """Destination shard per row (int32); dead rows map to
    ``num_shards``. ``(h >> 33) & 0x7FFFFFFF`` is uint64's logical
    shift."""
    h = _row_hash(data, cols)
    dest = ((h >> 33) & 0x7FFFFFFF) % num_shards
    return torch.where(live, dest.to(torch.int32), num_shards)


# -- the shard group ---------------------------------------------------------

class ShardGroup:
    """One daemon worker thread a shard, and the collectives between
    them. ``run(fn)`` calls ``fn(rank)`` on every worker at once; inside
    it a shard calls ``all_to_all`` and ``all_sum`` with its rank, every
    shard the same collectives in the same order."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.size = len(self.devices)
        self._spread = len(set(self.devices)) > 1
        self._barrier = threading.Barrier(self.size)
        self._slots = ([None] * self.size, [None] * self.size)
        self._calls = [0] * self.size
        self._jobs = [queue.SimpleQueue() for _ in self.devices]
        self._done: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        # shards that share a device take turns on it between collectives:
        # its one stream runs their kernels in turn anyway, and a shard's
        # temporaries are freed before the next shard's are allocated
        shared = {d for d in self.devices if self.devices.count(d) > 1}
        self._turns = {d: threading.Lock() for d in shared}
        self.threads = [threading.Thread(target=self._serve, args=(rank,),
                                         name=f"flowlog-shard-{rank}",
                                         daemon=True)
                        for rank in range(self.size)]
        for t in self.threads:
            t.start()

    def close(self) -> None:
        """Stop the workers (each ends after its current job)."""
        for jobs in self._jobs:
            jobs.put(None)

    # -- workers --------------------------------------------------------------
    def _serve(self, rank: int) -> None:
        while True:
            job = self._jobs[rank].get()
            if job is None:
                return
            fn, streams = job
            turn = self._turns.get(self.devices[rank])
            try:
                with turn or contextlib.nullcontext(), \
                        self._context(rank, streams):
                    out = (True, fn(rank))
            except BaseException as e:  # noqa: BLE001 — re-raised by run
                self._barrier.abort()
                out = (False, e)
            job = fn = None
            self._done.put((rank, out))
            out = None

    @contextlib.contextmanager
    def _context(self, rank: int, streams):
        """The shard's rank and device for the engine's code, its device
        and the controller's stream on it, and spans and counters off
        on every shard but 0."""
        device = self.devices[rank]
        _LOCAL.rank, _LOCAL.device = rank, device
        try:
            with contextlib.ExitStack() as stack:
                stack.enter_context(O.mute(rank > 0))
                if device.type == "cuda":
                    stack.enter_context(torch.cuda.device(device))
                    stack.enter_context(torch.cuda.stream(streams[rank]))
                yield
        finally:
            _LOCAL.rank = _LOCAL.device = None

    def run(self, fn) -> list:
        """``fn(rank)`` on every shard's worker, together -> the results
        by rank. An exception in one shard aborts the barrier, so every
        shard's call returns, and is raised here (the first by rank that
        is not the barrier's own)."""
        with self._lock:
            streams = [torch.cuda.current_stream(d)
                       if d.type == "cuda" else None for d in self.devices]
            for jobs in self._jobs:
                jobs.put((fn, streams))
            results = [None] * self.size
            for _ in range(self.size):
                rank, out = self._done.get()
                results[rank] = out
            self._slots = ([None] * self.size, [None] * self.size)
            failed = [out[1] for out in results if not out[0]]
            if failed:
                self._barrier.reset()
                self._calls = [0] * self.size
                raise next((e for e in failed if not isinstance(
                    e, threading.BrokenBarrierError)), failed[0])
            return [out[1] for out in results]

    # -- collectives ----------------------------------------------------------
    def _exchange(self, rank: int, item) -> list:
        """Every shard's ``item`` by rank, once all have given theirs.
        Two generations of slots alternate: a shard writes generation
        k + 2 only after barrier k + 1, which every shard passes only
        once it has read generation k."""
        call = self._calls[rank]
        self._calls[rank] = call + 1
        slots = self._slots[call % 2]
        event = None
        if self._spread and self.devices[rank].type == "cuda":
            event = torch.cuda.Event()
            event.record()
        slots[rank] = (item, event)
        turn = self._turns.get(self.devices[rank])
        if turn is not None:
            turn.release()
        try:
            self._barrier.wait()
        finally:
            if turn is not None:
                turn.acquire()
        # every shard has read the previous generation: drop this shard's
        self._slots[(call + 1) % 2][rank] = None
        return list(slots)

    def _here(self, rank: int, t: torch.Tensor, event) -> torch.Tensor:
        """``t`` (another shard's) on this shard's device."""
        device = self.devices[rank]
        if t.device == device:
            return t
        if event is not None:
            with torch.cuda.device(t.device):
                torch.cuda.current_stream().wait_event(event)
        return t.to(device)

    def all_to_all(self, rank: int, sends: tuple) -> tuple:
        """For each tensor of ``sends`` ([S, ...], block j for shard j):
        [S, ...] whose block j came from shard j."""
        got = self._exchange(rank, sends)
        return tuple(
            torch.stack([self._here(rank, item[i][rank], event)
                         for item, event in got])
            for i in range(len(sends)))

    def all_sum(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """The sum over shards of ``x``, on this shard's device."""
        got = self._exchange(rank, x)
        return torch.stack([self._here(rank, item, event)
                            for item, event in got]).sum(0)


# -- repartitioning ----------------------------------------------------------

def repartition_rows(data: torch.Tensor, val: Optional[torch.Tensor],
                     live: torch.Tensor, key_cols: tuple[int, ...],
                     sr: Semiring, out_cap: int, group: ShardGroup,
                     rank: int, backend=None):
    """All-to-all hash repartition on ``key_cols`` (shard ``rank``'s
    view; every shard of ``group`` calls it together).

    Buckets rows by destination into a padded [S, cap] send buffer, swaps
    buckets through the group, then dedupes the received rows —
    restoring the sorted-arrangement invariant and combining any
    duplicates that now co-locate. Returns (Relation, overflow)."""
    cap, arity = data.shape
    num_shards = group.size
    device = data.device
    if sr.has_value and val is None:
        val = torch.ones((cap,), dtype=sr.dtype, device=device)
    # the padded buffer IS the wire volume: every launch moves the whole
    # [S, cap, arity] send buffer a shard (int32 = 4 bytes; one plane
    # more when values ship)
    trace_count("shard.all_to_all.launches")
    trace_count("shard.all_to_all.slots", num_shards * cap)
    planes = arity + (1 if val is not None else 0)
    trace_count("shard.all_to_all.bytes", num_shards * cap * planes * 4)
    sends = _buckets(data, val, live, key_cols, sr, num_shards)
    recv = group.all_to_all(rank, sends)
    del sends
    flat = recv[0].reshape(num_shards * cap, arity)
    vflat = recv[1].reshape(num_shards * cap) if val is not None else None
    del recv
    return R.dedupe(flat, vflat, sr, out_cap, backend=backend)


def _buckets(data, val, live, key_cols, sr, num_shards) -> tuple:
    """The padded send buffers of ``repartition_rows``: rows in stable
    destination order, bucket s at [s, 0:count); dead rows dropped."""
    cap, arity = data.shape
    device = data.device
    dest = shard_of(data, key_cols, live, num_shards)
    order = torch.argsort(dest, stable=True)          # dead rows last
    dst = dest[order]
    starts = torch.searchsorted(
        dst, torch.arange(num_shards, dtype=torch.int32, device=device))
    within = torch.arange(cap, device=device) - starts[
        dst.clamp(0, num_shards - 1)]
    # slot dst * cap + within; a dead row goes to the spare slot S * cap
    target = torch.where(dst < num_shards,
                         dst.to(torch.int64) * cap + within,
                         num_shards * cap)
    sends = (R._scatter_rows(num_shards * cap, PAD, target,
                             data[order]).view(num_shards, cap, arity),)
    if val is not None:
        identity = sr.identity if sr.has_value else 0
        sends += (R._scatter_rows(num_shards * cap, identity, target,
                                  val[order]).view(num_shards, cap),)
    return sends


def repartition(rel: Relation, key_cols: tuple[int, ...], sr: Semiring,
                group: ShardGroup, rank: int,
                out_cap: Optional[int] = None, backend=None):
    """Repartition shard ``rank``'s block of a relation on ``key_cols``."""
    return repartition_rows(rel.data, rel.val, live_mask(rel), key_cols,
                            sr, out_cap or rel.capacity, group, rank,
                            backend=backend)


# -- partitioned relop wrappers ----------------------------------------------

class ShardedEvaluator(Evaluator):
    """The IR evaluator of one shard, with key-partitioned entry points:
    every binary op repartitions its operands on the operation key (so
    matching rows co-locate), then runs the ordinary shard-local op."""

    def __init__(self, cfg: LowerConfig, group: ShardGroup, rank: int):
        super().__init__(cfg)
        self.group = group
        self.rank = rank
        self.num_shards = group.size

    def _repart(self, rel: Relation, key_cols: tuple[int, ...]):
        """All-to-all repartition on the operation key — memoized per
        evaluation pass when the arrangement cache is on, so one
        repartition serves every rule keyed the same way on the same
        operand."""
        key_cols = tuple(key_cols)

        def compute():
            return repartition(rel, key_cols, self.cfg.semiring, self.group,
                               self.rank, backend=self.cfg.backend)

        if self.cache is None:
            return compute()
        return self.cache.memo(("repart", key_cols),
                               (rel.data, rel.val, rel.n), compute)

    def _join_op(self, left, right, l_keys, r_keys, l_out, r_out, out_cap):
        left, ov1 = self._repart(left, l_keys)
        right, ov2 = self._repart(right, r_keys)
        data, val, valid, total, ovj = super()._join_op(
            left, right, l_keys, r_keys, l_out, r_out, out_cap)
        return data, val, valid, total, ovj | ov1 | ov2

    def _semijoin_op(self, left, right, l_keys, r_keys):
        left, right, ov = self._co_partition(left, right, l_keys, r_keys)
        out, ov2 = super()._semijoin_op(left, right, l_keys, r_keys)
        return out, ov | ov2

    def _antijoin_op(self, left, right, l_keys, r_keys):
        left, right, ov = self._co_partition(left, right, l_keys, r_keys)
        out, ov2 = super()._antijoin_op(left, right, l_keys, r_keys)
        return out, ov | ov2

    def _co_partition(self, left, right, l_keys, r_keys):
        """Align semijoin/antijoin operands. Zero-key guards need no
        movement, but the 'is right non-empty?' test must be global —
        substitute the summed count (membership only compares n > 0)."""
        if len(l_keys) == 0:
            total = self.group.all_sum(self.rank, right.n)
            return left, Relation(right.data, right.val, total), (
                torch.zeros((), dtype=torch.bool, device=left.device))
        left, ov1 = self._repart(left, l_keys)
        right, ov2 = self._repart(right, r_keys)
        return left, right, ov1 | ov2

    def _reduce_op(self, child, group_cols, agg_specs, out_cap):
        # group-key partition: every group is local (an empty group
        # tuple hashes every row to one shard: the global aggregate)
        child, ov = self._repart(child, group_cols)
        out, ov2 = super()._reduce_op(child, group_cols, agg_specs,
                                      out_cap)
        return out, ov | ov2
    # dedupe/concat stay shard-local on purpose: cross-shard duplicates
    # of projected rows meet at the next repartition or at the head-row
    # re-home in _merge_head


# -- sharded fixpoint driver -------------------------------------------------

class ShardedEngine(Engine):
    """Drop-in Engine that hash-partitions every relation across a 1-D
    shard mesh and runs each shard's steps on its own thread. Selected by
    ``EngineConfig.shards >= 2`` (``repro_torch.engine.make_engine``).
    ``close()`` stops the workers (they also stop when the engine is
    collected)."""

    _sanitize_layer = "shard"

    def __init__(self, compiled: I.CompiledProgram,
                 config: EngineConfig | None = None):
        super().__init__(compiled, config)
        self.num_shards = max(int(self.cfg.shards or 1), 1)
        self.mesh = self.cfg.shard_mesh or make_shard_mesh(
            self.num_shards, self._device)
        if self.mesh.axis_names != (SHARD_AXIS,):
            raise ValueError(
                f"shard mesh must have the single axis {SHARD_AXIS!r}, "
                f"got {self.mesh.axis_names}")
        if self.mesh.size != self.num_shards:
            raise ValueError(f"mesh has {self.mesh.size} devices but "
                             f"config.shards={self.num_shards}")
        if any(d.type != self._device.type for d in self.mesh.devices):
            raise ValueError(f"shard devices {self.mesh.devices} are not "
                             f"of the engine's type {self._device.type}")
        self.group = ShardGroup(self.mesh.devices)
        self._close = weakref.finalize(self, self.group.close)

    def close(self) -> None:
        self._close()

    @property
    def device(self) -> torch.device:
        """The running shard's device on a worker, else the engine's."""
        device = getattr(_LOCAL, "device", None)
        return self._device if device is None else device

    @device.setter
    def device(self, value: torch.device) -> None:
        self._device = value

    # -- plumbing -------------------------------------------------------------
    def _on_shards(self, fn) -> list:
        return self.group.run(fn)

    def _read(self, scalars: list) -> list:
        """Scalar tensors from any shard as ints, in one device-to-host
        read."""
        return torch.stack([t.reshape(()).to(self._device, torch.int64)
                            for t in scalars]).tolist()

    def _evaluators(self) -> list:
        lcfg = LowerConfig(self.intermediate_cap, self.cfg.semiring,
                           self.backend, self.cfg.arrangements)
        return [ShardedEvaluator(lcfg, self.group, s)
                for s in range(self.num_shards)]

    def _scatter_env(self, rels: dict) -> dict:
        """Host-built (whole) Relations -> home-partitioned
        ShardedRelations: each shard keeps the rows whose full-row hash
        lands on it. Stable compaction keeps them sorted."""
        if not rels:
            return {}
        O.count(self.cfg.observe, "shard.scatter_env", len(rels))
        out = {}
        for k, rel in rels.items():
            sr = self._sr_of(k[0] if isinstance(k, tuple) else k)
            identity = sr.identity if sr.has_value else 0
            dest = shard_of(rel.data, tuple(range(rel.arity)),
                            live_mask(rel), self.num_shards)
            blocks = []
            for s, device in enumerate(self.mesh.devices):
                d, v, n, _ = R._scatter_compact(
                    rel.data, rel.val, dest == s, rel.capacity, identity)
                blocks.append(Relation(
                    d.to(device), None if rel.val is None else v.to(device),
                    n.to(device), order=rel.order))
            out[k] = ShardedRelation(blocks)
        return out

    def _edb_env(self, edbs, edb_caps) -> dict:
        return self._scatter_env(super()._edb_env(edbs, edb_caps))

    def _host_relation(self, rel) -> Relation:
        """Gather a ShardedRelation into one Relation on the engine's
        device. Home partitioning keeps rows globally distinct, so this
        is a concat of live blocks + one lexicographic sort —
        byte-identical to the single-device arrangement. The capacity is
        the blocks' (grown only if the rows need more), never shrunk to
        the row count; the value tail is 0, as the reference's."""
        if not isinstance(rel, ShardedRelation):
            return rel
        O.count(self.cfg.observe, "shard.host_gathers")
        home = self._device
        ns = self._read(list(rel.n))
        rows = torch.cat([b.data[:n].to(home)
                          for b, n in zip(rel.blocks, ns)])
        vals = None
        if rel.val is not None:
            vals = torch.cat([b.val[:n].to(home)
                              for b, n in zip(rel.blocks, ns)])
        total = rows.shape[0]
        cap = rel.capacity if total <= rel.capacity else pow2_cap(total)
        perm = _stable_lex_perm(rows)
        data = torch.full((cap, rel.arity), PAD, dtype=torch.int32,
                          device=home)
        data[:total] = rows[perm]
        val = None
        if vals is not None:
            val = torch.zeros((cap,), dtype=torch.int32, device=home)
            val[:total] = vals[perm]
        return Relation(data, val, torch.tensor(total, dtype=torch.int32,
                                                device=home))

    def _sanitize_copy(self, rel):
        if isinstance(rel, ShardedRelation):
            return ShardedRelation([Engine._sanitize_copy(self, b)
                                    for b in rel.blocks])
        return super()._sanitize_copy(rel)

    # -- stratum execution ----------------------------------------------------
    # (the stratum span comes from Engine._run_stratum)
    def _run_stratum_body(self, sp: I.StratumPlan, env_rels, stats,
                          stratum_key, init_state=None, st_span=None):
        F.fault_point("engine.stratum")
        obs = self.cfg.observe
        evs = self._evaluators()
        monoid_names = set(self.monoid)
        idbs = sorted(sp.idbs)
        nonrec = [p for p in sp.plans if p.variant == -1]
        rec = [p for p in sp.plans if p.variant >= 0]
        bases = [_local(dict(env_rels), s) for s in range(self.num_shards)]

        if init_state is not None:
            # the seeded continuation: stored fulls and seeds arrive
            # sharded; the engine's own _stratum_seed runs per shard
            with O.span(obs, "seed"):
                out = self._on_shards(lambda s: self._stratum_seed(
                    _local(init_state, s), idbs, evs[s]))
        else:
            with O.span(obs, "init", nonrec_rules=len(nonrec)):
                init_rels = self._scatter_env(
                    {name: self._ground_relation(sp, name)
                     for name in idbs})
                out = self._on_shards(lambda s: self._stratum_init(
                    bases[s], _local(init_rels, s), nonrec, idbs, evs[s],
                    monoid_names))
        states = [o[0] for o in out]
        if any(self._read([o[1] for o in out])):
            raise OverflowError_(f"overflow during init of {stratum_key}")

        delta_log = []
        stratum_iters = 0
        if sp.recursive and rec:
            if self.cfg.mode == "device":
                with O.span(obs, "fixpoint-loop", detail="post-hoc"):
                    states, stratum_iters = self._sharded_device_loop(
                        states, bases, rec, idbs, evs, monoid_names,
                        stratum_key)
            else:
                states, stratum_iters, delta_log = self._sharded_host_loop(
                    states, bases, rec, idbs, evs, monoid_names,
                    stratum_key)
            # final merge of the last deltas into the fulls (empty unless
            # device mode stopped at max_iters)
            with O.span(obs, "final-merge"):
                out = self._on_shards(
                    lambda s: self._final_merge(states[s], idbs))
                if any(self._read([o[1] for o in out])):
                    raise OverflowError_(
                        f"overflow finalizing {stratum_key}")
            fulls = [o[0] for o in out]
        else:
            fulls = [{name: st[name][0] for name in idbs} for st in states]
        full_env = dict(env_rels)
        for name in idbs:
            full_env[(name, I.FULL)] = ShardedRelation(
                [f[name] for f in fulls])
        stats.iterations[stratum_key] = stratum_iters
        if sp.recursive and rec:
            stats.delta_sizes[stratum_key] = delta_log
        if st_span is not None:
            st_span.attrs["iterations"] = stratum_iters
        self._sanitize_env(full_env, f"stratum {stratum_key} boundary")
        return full_env

    def _final_merge(self, state: dict, idbs) -> tuple:
        """One shard's last deltas merged into its fulls -> (fulls,
        overflow)."""
        out = {}
        ovf = self._zero_flag()
        for name in idbs:
            full, delta = state[name]
            out[name], ov = R.merge(full, delta, self._sr_of(name),
                                    self._idb_cap(name),
                                    backend=self.backend,
                                    incremental=self.cfg.arrangements)
            ovf = ovf | ov
        return out, ovf

    def _sharded_host_loop(self, states, bases, rec, idbs, evs,
                           monoid_names, stratum_key):
        """mode="host": rounds of shard iterations while any shard's
        delta is non-empty -> (states, iterations, delta sizes). One read
        an iteration: every shard's overflow flag and delta counts."""
        obs = self.cfg.observe
        shards = range(self.num_shards)

        def sizes_of(states) -> dict:
            counts = self._read([states[s][n][1].n
                                 for n in idbs for s in shards])
            return {n: sum(counts[i * len(shards):(i + 1) * len(shards)])
                    for i, n in enumerate(idbs)}

        stratum_iters = 0
        delta_log = []
        sizes = sizes_of(states)
        while any(sizes.values()):
            delta_total = sum(sizes.values())
            delta_log.append(delta_total)
            with O.span(obs, "iteration", index=stratum_iters,
                        delta_rows=delta_total,
                        deltas=dict(sizes) if obs else None):
                prev = states
                out = self._on_shards(lambda s: self._stratum_iter(
                    prev[s], bases[s], rec, idbs, evs[s], monoid_names))
                states = [o[0] for o in out]
                flags = self._read(
                    [o[1] for o in out]
                    + [states[s][n][1].n for n in idbs for s in shards])
                k = len(shards)
                sizes = {n: sum(flags[k + i * k:k + (i + 1) * k])
                         for i, n in enumerate(idbs)}
            if any(flags[:k]):
                raise OverflowError_(
                    f"overflow in stratum {stratum_key} "
                    f"iter {stratum_iters}")
            stratum_iters += 1
            if stratum_iters >= self.cfg.max_iters:
                raise RuntimeError(
                    f"no fixpoint after {self.cfg.max_iters} iterations")
        return states, stratum_iters, delta_log

    def _sharded_device_loop(self, states, bases, rec, idbs, evs,
                             monoid_names, stratum_key):
        """mode="device": the reference's sharded ``while_loop`` ->
        (states, iterations). Each shard's log [any_delta, overflow,
        iterations] starts at [1, 0, 0]; an iteration folds the group's
        sums of delta rows and overflow flags into every shard's log (an
        iteration counts while any_delta & ~overflow), and the
        controller reads shard 0's log once an iteration: it stops when
        no shard has a delta, raises on overflow (so ``run()`` grows the
        caps), and stops quietly at ``max_iters`` with the partial
        fixpoint."""
        if self.cfg.max_iters <= 0:
            return states, 0
        logs = [torch.tensor([1, 0, 0], dtype=torch.int32, device=d)
                for d in self.mesh.devices]

        def step(s, st):
            new, ovf = self._stratum_iter(st, bases[s], rec, idbs, evs[s],
                                          monoid_names)
            local = torch.stack(
                [torch.stack([new[n][1].n for n in idbs]).sum(),
                 ovf.to(torch.int64)]).to(torch.int32)
            total = self.group.all_sum(s, local)
            log = logs[s]
            counted = (log[0] != 0) & (log[1] == 0)
            logs[s] = torch.stack([
                (total[0] > 0).to(torch.int32),
                ((log[1] != 0) | (total[1] > 0)).to(torch.int32),
                log[2] + counted.to(torch.int32)])
            return new

        goes_on = True
        while goes_on:
            prev = states
            states = self._on_shards(lambda s: step(s, prev[s]))
            flags = logs[0].tolist()
            goes_on = self._loop_goes_on(flags, stratum_key)
        return states, flags[2]

    # -- head merge: re-home derived rows before combining --------------------
    def _merge_head(self, rels: list, sr: Semiring, cap: int):
        data = torch.cat([r.data for r in rels], dim=0)
        val = None
        if sr.has_value:
            val = torch.cat([
                r.val if r.val is not None
                else torch.ones((r.capacity,), dtype=sr.dtype,
                                device=r.device)
                for r in rels])
        live = ~torch.all(data == PAD, dim=1)
        return repartition_rows(
            data, val, live, tuple(range(data.shape[1])), sr, cap,
            self.group, _rank(), backend=self.backend)

    # -- maintenance driver hooks (incremental.py runs through these) ---------
    def run_rule_pass(self, env_rels, roots, restrict=None,
                      memo_key=None, context: str = "") -> dict:
        """Sharded maintenance pass: the shared ``_rule_pass_body`` runs
        on every shard with the key-partitioned evaluator, so every
        retagged rule occurrence repartitions its operands on the
        operation key as the batch fixpoint does, and ``_merge_head``
        re-homes derived rows. Inputs must already be in stored (sharded)
        form (``_stored``). ``memo_key`` has no effect, as on one
        device."""
        F.fault_point("engine.rule_pass")
        evs = self._evaluators()
        env_rels, restrict = dict(env_rels), dict(restrict or {})
        out = self._on_shards(lambda s: self._rule_pass_body(
            _local(env_rels, s), roots, _local(restrict, s), evs[s]))
        if any(self._read([o[1] for o in out])):
            raise OverflowError_(
                self._overflow_msg("incremental rule pass", context))
        return {head: ShardedRelation([o[0][head] for o in out])
                for head in out[0][0]}

    def _stored(self, rels: dict) -> dict:
        """Scatter host-built Relations to their home shards; entries
        already in sharded form pass through unchanged."""
        host = {k: v for k, v in rels.items()
                if not isinstance(v, ShardedRelation)}
        scattered = self._scatter_env(host)
        return {k: scattered.get(k, rels[k]) for k in rels}

    def _stored_empty_idb(self, name: str) -> ShardedRelation:
        e = self._empty_idb(name)
        return ShardedRelation([
            Relation(e.data.to(d, copy=True),
                     None if e.val is None else e.val.to(d, copy=True),
                     e.n.to(d, copy=True))
            for d in self.mesh.devices])

    def _difference_stored(self, rel, sub):
        """Shard-local set difference: both operands are home-partitioned
        by full-row hash, so equal rows co-locate and no repartition is
        needed (the DRed candidate-removal step)."""
        return ShardedRelation(self._on_shards(lambda s: R.difference(
            rel.blocks[s], sub.blocks[s], backend=self.backend)[0]))

    def _union_stored(self, rels: list, sr: Semiring, cap: int,
                      context: str = ""):
        """Shard-local union of home-partitioned relations (duplicates
        co-locate, so concat + dedupe needs no communication)."""
        out = self._on_shards(lambda s: R.concat_all(
            [r.blocks[s] for r in rels], sr, cap, backend=self.backend))
        if any(self._read([o[1] for o in out])):
            raise OverflowError_(self._overflow_msg(
                "maintenance seed union", context))
        return ShardedRelation([o[0] for o in out])
