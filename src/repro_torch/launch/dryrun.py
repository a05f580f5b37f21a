"""Dry run of every arch x published shape, after
``repro.launch.dryrun``, without allocating memory: on one card's terms
(``--mesh local``, the default) or on the reference's production meshes
(``--mesh single|multi|both``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all]
        [--shape all] [--mesh local|single|multi|both]
        [--out results/dryrun_torch] [--verbose]

For each cell, at full width and depth, every tensor on
``torch.device("meta")`` (a shape and a dtype, no storage):

- **Gate.** The model is built from ``state_specs`` and the step of
  ``step_fn`` runs once on ``input_specs``: the counterpart of the
  reference's "must lower". A cell whose step raises has ``ok`` false and
  the traceback. The kernel wrappers take their plain versions on meta
  tensors (``kernels._build.runs_plain``), so the step's shapes are
  those of the plain route.
- **Counts** (``StepCounter``, a dispatch mode). FLOPs of the products
  in ``torch.utils.flop_counter``'s registry, those ``FlopCounterMode``
  counts (matrix products, batched ones and einsums through them, SDPA,
  convolutions: elementwise work is not counted, so these FLOPs are not
  comparable with XLA's); bytes accessed, the operand and result bytes
  of every aten op but views and allocations (unfused, so an upper
  bound, as XLA-CPU's is); and
  transcendentals, the result elements of the exp, log, tanh, sigmoid,
  erf, sin, cos, sqrt, rsqrt and pow families, of the softmaxes and of
  the activations built on them (silu, gelu). An LM counts at 1 and 2 layers and
  scales to its depth (``_scale_costs``, the reference's exact scaling
  of homogeneous layers); a GNN and the FM count their whole step.
- **Reckoning.** State, traffic and activation bytes from the traffic
  models of ``configs.base`` on one device; the roofline's compute and
  memory times at ``launch.mesh.HARDWARE``'s figures (the H100).

One JSON a cell, ``<arch>__<shape>__1xH100.json`` under ``--out``, with
the reference's keys: ``mesh`` is "1xH100" and ``n_devices`` 1;
``fits_80gb_hbm`` takes the place of ``fits_16gb_hbm`` and ``trace_s``
(the gate's seconds) that of ``lower_s`` and ``compile_s``; collective
bytes and counts are 0 (one card). XLA's ``memory_analysis`` has no
counterpart. Beside them, ``io_bytes_per_device`` (the inputs: the
decode's cache) and ``resident_fits_80gb_hbm`` (state and inputs
together). Every cell is run afresh. Exits 1 when a cell failed.

**Production meshes** (``--mesh single``: 16 x 16 ("data", "model"),
256 devices; ``multi``: 2 x 16 x 16 ("pod", "data", "model"), 512;
``both``: each cell on each). ``launch.mesh.make_production_mesh`` builds
the mesh over the fake process group, so nothing is allocated and no
peer exists: the step's state and inputs are meta DTensors laid out by
the arch's ``shardings`` (``configs.base.place``), the model runs under
``use_mesh`` (on ``launch.mesh.compute_mesh``'s 2-D flattening for the
multi-pod mesh), and what each device computes is its local shard's ops.
``StepCounter`` counts them per device as on one card, and the
collectives as ``collective_bytes`` does, the counterpart of the
reference's HLO parse: the ``c10d_functional`` (and ``_dtensor``)
collectives that DTensor issues, by the reference's five kinds, with
each one's result bytes on a device. The GNN and FM steps
run under ``implicit_replication`` (their constant tables and ranges are
plain tensors, whole on every device); the LM step needs none. One JSON
a cell, ``<arch>__<shape>__{single,multi}.json``: the reference's keys
("mesh" "16x16" or "2x16x16"), ``trace_s`` as above, ``fits_80gb_hbm``
of the per-device state, the roofline's ``collective_s`` (2 x the
all-reduce bytes plus the others', over ``HARDWARE["link_bw"]``) and
``dominant`` as the reference's. DTensor issues collectives in the
tensors' own dtypes, so ``bf16_collective_adjust`` is 1.0. These
collectives are DTensor's choices, not XLA's partitioner's: their counts
and bytes are not comparable with the reference's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import contextlib

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_NAMES, base as B, get_arch
from repro_torch.launch.mesh import (
    HARDWARE, compute_mesh, destroy_process_group, make_production_mesh,
    use_mesh,
)
from repro_torch.models import transformer as T
from repro_torch.models.recsys import fm as FM
from repro_torch.training.optim import TrainState

META = torch.device("meta")
MESH = "1xH100"
MESHES = {"local": [None], "single": [False], "multi": [True],
          "both": [False, True]}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_aten = torch.ops.aten
TRANSCENDENTAL = {getattr(_aten, name) for name in (
    "exp", "exp_", "exp2", "exp2_", "expm1", "log", "log_", "log2", "log10",
    "log1p", "tanh", "tanh_", "sigmoid", "sigmoid_", "erf", "erf_", "erfc",
    "erfinv", "_softmax", "_log_softmax", "logsumexp", "silu", "silu_",
    "gelu", "sin", "cos", "rsqrt", "sqrt", "pow")}
# ops that move no bytes of their own: allocations
NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
            _aten.new_empty, _aten.new_empty_strided}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def _collective_kind(func):
    """The reference's kind of a collective op ("all-reduce" ...), None
    for any other op; raises on a collective of no such kind."""
    if func.namespace not in ("_c10d_functional", "c10d_functional",
                              "_dtensor", "c10d"):
        return None
    name = func.overloadpacket.__name__
    if name in ("wait_tensor", "_wrap_tensor_autograd"):
        return None
    for key, kind in (("all_reduce", "all-reduce"),
                      ("all_gather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("permute", "collective-permute")):
        if key in name:
            return kind
    raise ValueError(f"collective of no counted kind: {func}")


class StepCounter(TorchDispatchMode):
    """A step's counts on one device, over the aten ops run under it:
    FLOPs of the products in ``flop_counter``'s registry (those that
    ``FlopCounterMode`` counts), the bytes of every op's tensor operands
    and results (views and allocations aside), the result elements of
    transcendental ops, and the collectives' counts and result bytes by
    the reference's kinds. On a mesh it lets DTensor run first (returning
    NotImplemented for DTensor ops, as torch's CommDebugMode does), and
    so sees the local ops each device runs and the collectives DTensor
    issues for them; DTensor's sharding propagation runs ops on fake
    tensors of the global shapes, which are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.collective_bytes = {c: 0 for c in COLLECTIVES}
        self.collective_counts = {c: 0 for c in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        if any(isinstance(t, FakeTensor)
               for t in _leaves((args, kwargs, out))):
            return out
        kind = _collective_kind(func)
        if kind is not None:
            self.collective_bytes[kind] += _nbytes(out)
            self.collective_counts[kind] += 1
            return out
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and packet not in NO_BYTES:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if packet in TRANSCENDENTAL:
            self.transcendentals += sum(
                t.numel() for t in _leaves(out) if isinstance(t, torch.Tensor))
        return out


def collective_bytes(fn, *args, **kwargs) -> dict:
    """The collectives that ``fn(*args, **kwargs)`` issues (DTensor's, on
    a mesh), counted by ``StepCounter``: the counterpart of the
    reference's parse of the compiled HLO. {"bytes": kind -> result bytes
    on a device, "counts": kind -> ops, "total_bytes"}."""
    counter = StepCounter()
    with counter:
        fn(*args, **kwargs)
    return {"bytes": dict(counter.collective_bytes),
            "counts": dict(counter.collective_counts),
            "total_bytes": sum(counter.collective_bytes.values())}


def _build(arch, shape_name: str, state, batch):
    """(step, its arguments) over the given state and inputs (meta
    tensors, or meta DTensors on a mesh): the model built on the meta
    device from the state."""
    kind = arch.shapes[shape_name].kind
    train = kind in ("train", "graph", "recsys_train")
    params = state.params if train else state
    if arch.family == "lm":
        model = T.Transformer(arch.step_cfg(shape_name), params, device=META,
                              train=train)
    elif arch.family == "gnn":
        model = arch.model_fn(arch.config(shape_name), params, META,
                              train=True)
    else:
        model = FM.FM(arch.cfg, params, device=META, train=train)
    step = arch.step_fn(shape_name)
    if train:
        return step, (model, TrainState(model.param_tree(), state.mu,
                                        state.nu, state.step), batch)
    return step, (model, batch)


def _step_and_args(arch, shape_name: str):
    """(step, its arguments): the model built on the meta device from
    ``state_specs``, the state (train) and ``input_specs``."""
    return _build(arch, shape_name, arch.state_specs(shape_name),
                  arch.input_specs(shape_name))


def _run(arch, shape_name: str) -> None:
    step, args = _step_and_args(arch, shape_name)
    step(*args)


def _scale_costs(c1: dict, c2: dict, n_layers: int) -> dict:
    """Exact homogeneous-layer scaling: total = c1 + (L - 1) (c2 - c1)."""
    out = {k: c1[k] + (n_layers - 1) * max(c2[k] - c1[k], 0.0)
           for k in ("flops", "bytes_accessed", "transcendentals")}
    for k in ("collective_bytes", "collective_counts"):
        out[k] = {c: c1[k][c] + (n_layers - 1) * max(c2[k][c] - c1[k][c], 0)
                  for c in c1[k]}
    out["layer_scaled"] = True
    return out


def _at_depth(arch, layers: int):
    return dataclasses.replace(
        arch, cfg=dataclasses.replace(arch.cfg, n_layers=layers))


def traffic(arch, shape_name: str, mesh=B.ONE_CARD) -> dict:
    """The traffic model of the arch's family on one device of ``mesh``
    (one card by default)."""
    if arch.family == "lm":
        return B.lm_traffic_model(arch, mesh, shape_name)
    if arch.family == "gnn":
        return B.gnn_traffic_model(arch, mesh, shape_name)
    return B.recsys_traffic_model(arch, mesh, shape_name)


def _run_meshed(arch, shape_name: str, mesh, counter=None) -> None:
    """The step once on ``mesh``, its state and inputs laid out by the
    arch's ``shardings``; under ``counter`` when given."""
    (state_sp, batch_sp), _ = arch.shardings(mesh, shape_name)
    on = compute_mesh(mesh)
    state = B.place(arch.state_specs(shape_name), state_sp, on)
    batch = B.place(arch.input_specs(shape_name), batch_sp, on)
    step, args = _build(arch, shape_name, state, batch)
    plain = (contextlib.nullcontext() if arch.family == "lm"
             else implicit_replication())
    with use_mesh(mesh), plain, (counter or contextlib.nullcontext()):
        step(*args)


def _costs(arch, shape_name: str, mesh=None) -> dict:
    """The step's FLOPs, bytes accessed, transcendentals and collectives
    on one device (of ``mesh``; one card when None), on meta."""
    counter = StepCounter()
    if mesh is None:
        step, args = _step_and_args(arch, shape_name)
        with counter:
            step(*args)
    else:
        _run_meshed(arch, shape_name, mesh, counter)
    return {"flops": float(counter.flops),
            "bytes_accessed": float(counter.bytes),
            "transcendentals": float(counter.transcendentals),
            "collective_bytes": dict(counter.collective_bytes),
            "collective_counts": dict(counter.collective_counts)}


def _roofline(arch, shape_name: str, flops: float, traffic_bytes: int,
              collective: dict, n_dev: int) -> dict:
    hw = HARDWARE
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = traffic_bytes / hw["hbm_bw"]
    weighted = 2 * collective["all-reduce"] + sum(
        v for k, v in collective.items() if k != "all-reduce")
    collective_s = weighted / hw["link_bw"] if n_dev > 1 else 0.0
    model_flops = arch.model_flops(shape_name) / n_dev
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max([("compute", compute_s), ("memory", memory_s),
                         ("collective", collective_s)],
                        key=lambda kv: kv[1])[0],
        "step_s_lower_bound": max(compute_s, memory_s, collective_s),
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": model_flops / flops if flops > 0 else None,
    }


def run_cell(arch_name: str, shape_name: str, multi_pod=None) -> dict:
    """One cell: on one card when ``multi_pod`` is None, else on the
    production mesh (multi-pod when true; see the module docstring)."""
    arch = get_arch(arch_name)
    mesh = (None if multi_pod is None
            else make_production_mesh(multi_pod=multi_pod))
    n_dev = 1 if mesh is None else mesh.size()
    t0 = time.perf_counter()
    if mesh is None:                    # the gate, at full depth
        _run(arch, shape_name)
    else:
        _run_meshed(arch, shape_name, mesh)
    trace_s = round(time.perf_counter() - t0, 2)
    if arch.family == "lm":
        costs = _scale_costs(_costs(_at_depth(arch, 1), shape_name, mesh),
                             _costs(_at_depth(arch, 2), shape_name, mesh),
                             arch.cfg.n_layers)
    else:
        costs = dict(_costs(arch, shape_name, mesh), layer_scaled=False)
    on = B.ONE_CARD if mesh is None else mesh
    tm = traffic(arch, shape_name, on)
    (_, batch_sp), _ = arch.shardings(on, shape_name)
    io = B._sharded_bytes(arch.input_specs(shape_name), batch_sp, on)
    cap = HARDWARE["hbm_bytes"]
    return {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": (MESH if mesh is None else
                 "2x16x16" if multi_pod else "16x16"),
        "n_devices": n_dev,
        "ok": True,
        "trace_s": trace_s,
        "memory": {
            "state_bytes_per_device": tm["state_bytes"],
            "traffic_bytes_per_device": tm["bytes"],
            "act_bytes_per_device": tm["act_bytes"],
            "io_bytes_per_device": io,
            "fits_80gb_hbm": bool(tm["state_bytes"] < cap),
            "resident_fits_80gb_hbm": bool(tm["state_bytes"] + io < cap),
        },
        "cost_per_device": costs,
        "bf16_collective_adjust": 1.0,
        "roofline": _roofline(arch, shape_name, costs["flops"], tm["bytes"],
                              costs["collective_bytes"], n_dev),
    }


def _cell(arch_name: str, shape_name: str, multi) -> tuple:
    """(tag, result) of one cell: on one card when ``multi`` is None,
    else on the production mesh (multi-pod when true)."""
    where = MESH if multi is None else ("multi" if multi else "single")
    tag = f"{arch_name}__{shape_name}__{where}"
    print(f"[run ] {tag}", flush=True)
    try:
        res = run_cell(arch_name, shape_name, multi)
        extra = ""
        if multi is not None:
            extra = (f" state/dev={res['memory']['state_bytes_per_device']}"
                     f" coll={sum(res['cost_per_device']['collective_bytes'].values())}")
        print(f"[ ok ] {tag}: trace={res['trace_s']}s "
              f"flops={res['cost_per_device']['flops']:.3e} "
              f"dominant={res['roofline']['dominant']}{extra}", flush=True)
    except Exception as e:  # noqa: BLE001 (a cell's failure is data)
        res = {"arch": arch_name, "shape": shape_name, "mesh": where,
               "ok": False, "error": repr(e),
               "traceback": traceback.format_exc()}
        print(f"[FAIL] {tag}: {e}", flush=True)
    return tag, res


def main(argv=None) -> dict:
    """Runs the cells; returns {tag: result}. Exits 1 when one failed."""
    ap = argparse.ArgumentParser(description="Dry run on the meta device")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="local", choices=list(MESHES),
                    help="local: one card (1xH100); single: 16x16; "
                         "multi: 2x16x16; both: single and multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--verbose", action="store_true",
                    help="print each cell's JSON")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    results, failures = {}, []
    try:
        for arch_name in archs:
            arch = get_arch(arch_name)
            shapes = (list(arch.shapes) if args.shape == "all"
                      else [args.shape])
            for shape_name in shapes:
                for multi in MESHES[args.mesh]:
                    tag, res = _cell(arch_name, shape_name, multi)
                    if not res["ok"]:
                        failures.append(tag)
                    if args.verbose:
                        print(json.dumps(res, indent=2), flush=True)
                    (outdir / f"{tag}.json").write_text(
                        json.dumps(res, indent=2))
                    results[tag] = res
    finally:
        destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        sys.exit(1)
    print("\nall dry-run cells passed")
    return results


if __name__ == "__main__":
    main()
