"""The FlowLog fixpoint engine on torch (host mode, one device)."""
from repro_torch.engine.backend import (
    CUDA, TORCH, CudaDispatch, KernelDispatch, TorchDispatch,
    resolve_backend,
)
from repro_torch.engine.engine import (
    Engine, EngineConfig, EngineStats, OverflowError_,
)
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


def make_engine(compiled, config: EngineConfig | None = None) -> Engine:
    """Engine factory. Only the single-device batch engine is ported;
    the sharded and incremental engines are queued in ROADMAP.md."""
    return Engine(compiled, config)


__all__ = [
    "PRESENCE", "COUNTING", "MIN_MONOID", "MAX_MONOID", "Semiring",
    "Relation", "from_numpy", "from_arrays", "to_numpy", "to_arrays",
    "CUDA", "TORCH", "CudaDispatch", "KernelDispatch", "TorchDispatch",
    "resolve_backend",
    "Engine", "EngineConfig", "EngineStats", "OverflowError_",
    "make_engine",
    "FaultError", "FaultPlan", "FaultSpec", "SimulatedCrash",
    "REGISTRY", "MetricsRegistry", "Observation", "validate_chrome_trace",
]
