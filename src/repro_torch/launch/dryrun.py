"""Dry run of every arch x published shape on one card's terms, after
``repro.launch.dryrun``, without allocating memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all]
        [--shape all] [--out results/dryrun_torch] [--verbose]

For each cell, at full width and depth, every tensor on
``torch.device("meta")`` (a shape and a dtype, no storage):

- **Gate.** The model is built from ``state_specs`` and the step of
  ``step_fn`` runs once on ``input_specs``: the counterpart of the
  reference's "must lower". A cell whose step raises has ``ok`` false and
  the traceback. The kernel wrappers take their plain versions on meta
  tensors (``kernels._build.runs_plain``), so the step's shapes are
  those of the plain route.
- **Counts.** FLOPs from ``torch.utils.flop_counter.FlopCounterMode``
  (matrix products, batched ones and einsums through them, SDPA,
  convolutions: elementwise work is not counted, so these FLOPs are not
  comparable with XLA's); bytes accessed from a dispatch mode that adds
  the operand and result bytes of every aten op but views and
  allocations (unfused, so an upper bound, as XLA-CPU's is); and
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
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves as _leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, base as B, get_arch
from repro_torch.launch.mesh import HARDWARE
from repro_torch.models import transformer as T
from repro_torch.models.recsys import fm as FM
from repro_torch.training.optim import TrainState

META = torch.device("meta")
MESH = "1xH100"
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


class ByteCounter(TorchDispatchMode):
    """Adds up, over the aten ops run under it, the bytes of their tensor
    operands and results (views and allocations aside) and the result
    elements of transcendental ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func.overloadpacket not in NO_BYTES:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if func.overloadpacket in TRANSCENDENTAL:
            self.transcendentals += sum(
                t.numel() for t in _leaves(out) if isinstance(t, torch.Tensor))
        return out


def _step_and_args(arch, shape_name: str):
    """(step, its arguments): the model built on the meta device from
    ``state_specs``, the state (train) and ``input_specs``."""
    kind = arch.shapes[shape_name].kind
    train = kind in ("train", "graph", "recsys_train")
    state = arch.state_specs(shape_name)
    params = state.params if train else state
    if arch.family == "lm":
        model = T.Transformer(arch.cfg, params, device=META, train=train)
    elif arch.family == "gnn":
        model = arch.model_fn(arch.config(shape_name), params, META,
                              train=True)
    else:
        model = FM.FM(arch.cfg, params, device=META, train=train)
    step = arch.step_fn(shape_name)
    batch = arch.input_specs(shape_name)
    if train:
        return step, (model, TrainState(model.param_tree(), state.mu,
                                        state.nu, state.step), batch)
    return step, (model, batch)


def _run(arch, shape_name: str) -> None:
    step, args = _step_and_args(arch, shape_name)
    step(*args)


def _costs(arch, shape_name: str) -> dict:
    """The step's FLOPs, bytes accessed and transcendentals on meta."""
    step, args = _step_and_args(arch, shape_name)
    with FlopCounterMode(display=False) as flops, ByteCounter() as count:
        step(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(count.bytes),
            "transcendentals": float(count.transcendentals),
            "collective_bytes": {c: 0 for c in COLLECTIVES},
            "collective_counts": {c: 0 for c in COLLECTIVES}}


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


def traffic(arch, shape_name: str) -> dict:
    """The traffic model of the arch's family on one device."""
    if arch.family == "lm":
        return B.lm_traffic_model(arch, shape_name)
    if arch.family == "gnn":
        return B.gnn_traffic_model(arch, shape_name)
    return B.recsys_traffic_model(arch, shape_name)


def run_cell(arch_name: str, shape_name: str) -> dict:
    arch = get_arch(arch_name)
    t0 = time.perf_counter()
    _run(arch, shape_name)              # the gate, at full depth
    trace_s = round(time.perf_counter() - t0, 2)
    if arch.family == "lm":
        costs = _scale_costs(_costs(_at_depth(arch, 1), shape_name),
                             _costs(_at_depth(arch, 2), shape_name),
                             arch.cfg.n_layers)
    else:
        costs = dict(_costs(arch, shape_name), layer_scaled=False)
    tm = traffic(arch, shape_name)
    io = B._tree_bytes(arch.input_specs(shape_name))
    hw = HARDWARE
    flops = costs["flops"]
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = tm["bytes"] / hw["hbm_bw"]
    collective_s = 0.0
    model_flops = arch.model_flops(shape_name)
    return {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": MESH,
        "n_devices": 1,
        "ok": True,
        "trace_s": trace_s,
        "memory": {
            "state_bytes_per_device": tm["state_bytes"],
            "traffic_bytes_per_device": tm["bytes"],
            "act_bytes_per_device": tm["act_bytes"],
            "io_bytes_per_device": io,
            "fits_80gb_hbm": bool(tm["state_bytes"] < hw["hbm_bytes"]),
            "resident_fits_80gb_hbm": bool(
                tm["state_bytes"] + io < hw["hbm_bytes"]),
        },
        "cost_per_device": costs,
        "bf16_collective_adjust": 1.0,
        "roofline": {
            "compute_s": compute_s,
            "memory_s": memory_s,
            "collective_s": collective_s,
            "dominant": max([("compute", compute_s), ("memory", memory_s),
                             ("collective", collective_s)],
                            key=lambda kv: kv[1])[0],
            "step_s_lower_bound": max(compute_s, memory_s, collective_s),
            "model_flops_per_device": model_flops,
            "useful_flops_ratio": (model_flops / flops if flops > 0
                                   else None),
        },
    }


def main(argv=None) -> dict:
    """Runs the cells; returns {tag: result}. Exits 1 when one failed."""
    ap = argparse.ArgumentParser(description="Dry run on the meta device")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--verbose", action="store_true",
                    help="print each cell's JSON")
    args = ap.parse_args(argv)

    archs = list(ARCH_NAMES) if args.arch == "all" else [args.arch]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    results, failures = {}, []
    for arch_name in archs:
        arch = get_arch(arch_name)
        shapes = list(arch.shapes) if args.shape == "all" else [args.shape]
        for shape_name in shapes:
            tag = f"{arch_name}__{shape_name}__{MESH}"
            print(f"[run ] {tag}", flush=True)
            try:
                res = run_cell(arch_name, shape_name)
                print(f"[ ok ] {tag}: trace={res['trace_s']}s "
                      f"flops={res['cost_per_device']['flops']:.3e} "
                      f"dominant={res['roofline']['dominant']}", flush=True)
            except Exception as e:  # noqa: BLE001 (a cell's failure is data)
                res = {"arch": arch_name, "shape": shape_name, "mesh": MESH,
                       "ok": False, "error": repr(e),
                       "traceback": traceback.format_exc()}
                failures.append(tag)
                print(f"[FAIL] {tag}: {e}", flush=True)
            if args.verbose:
                print(json.dumps(res, indent=2), flush=True)
            (outdir / f"{tag}.json").write_text(json.dumps(res, indent=2))
            results[tag] = res
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        sys.exit(1)
    print("\nall dry-run cells passed")
    return results


if __name__ == "__main__":
    main()
