"""The FlowLog fixpoint engine on torch (host and device mode, batch and
incremental, on one device or sharded)."""
from repro_torch.engine.backend import (
    CUDA, TORCH, CudaDispatch, KernelDispatch, TorchDispatch,
    resolve_backend,
)
from repro_torch.engine.engine import (
    Engine, EngineConfig, EngineStats, OverflowError_,
)
from repro_torch.engine.incremental import IncrementalEngine
from repro_torch.engine.faults import (
    FaultError, FaultPlan, FaultSpec, SimulatedCrash,
)
from repro_torch.engine.observe import (
    REGISTRY, MetricsRegistry, Observation, validate_chrome_trace,
)
from repro_torch.engine.relation import (
    Relation, from_arrays, from_numpy, to_arrays, to_numpy,
)
from repro_torch.engine.semiring import (
    COUNTING, MAX_MONOID, MIN_MONOID, PRESENCE, Semiring,
)


def make_engine(compiled, config: EngineConfig | None = None,
                incremental: bool = False):
    """Engine factory: ``config.shards >= 2`` selects the sharded driver
    (engine/shard.py), else the single-device ``Engine`` (host or device
    mode either way). The two are byte-identical in results and
    iteration counts. ``incremental=True`` wraps the selected driver in
    an ``IncrementalEngine`` (initialize / apply / snapshot): the two
    axes compose. For durable serving (WAL, snapshots, recovery) build a
    ``DurableIncrementalEngine`` (engine/resilience.py)."""
    if incremental:
        return IncrementalEngine(compiled, config)
    if config is not None and int(config.shards or 0) >= 2:
        from repro_torch.engine.shard import ShardedEngine
        return ShardedEngine(compiled, config)
    return Engine(compiled, config)


def __getattr__(name):
    # the resilience layer imports checkpoint/, which imports this
    # package's faults module: load it lazily, as the reference does
    if name in ("DurableIncrementalEngine", "ResilienceConfig",
                "SnapshotMismatch", "UpdateLog"):
        from repro_torch.engine import resilience
        return getattr(resilience, name)
    raise AttributeError(name)


__all__ = [
    "PRESENCE", "COUNTING", "MIN_MONOID", "MAX_MONOID", "Semiring",
    "Relation", "from_numpy", "from_arrays", "to_numpy", "to_arrays",
    "CUDA", "TORCH", "CudaDispatch", "KernelDispatch", "TorchDispatch",
    "resolve_backend",
    "Engine", "EngineConfig", "EngineStats", "OverflowError_",
    "IncrementalEngine", "make_engine",
    "FaultError", "FaultPlan", "FaultSpec", "SimulatedCrash",
    "REGISTRY", "MetricsRegistry", "Observation", "validate_chrome_trace",
    "DurableIncrementalEngine", "ResilienceConfig", "SnapshotMismatch",
    "UpdateLog",
]
