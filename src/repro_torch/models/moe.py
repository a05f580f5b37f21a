"""Token-choice top-k MoE with sort-based dispatch, after
``repro.models.moe``.

The tokens [T, d] are cut into ``g`` groups of ``tg`` tokens (the GShard
group axis: ``g`` is the largest divisor of T that is at most
``groups``), and each group is routed on its own with a capacity of
``cap`` assignments an expert. So ``groups`` decides which tokens exceed
an expert's capacity and drop: it is part of the model. Within a group,
as the reference does:

  1. *route*: router logits in float32, softmax, top-k, renormalised;
  2. *arrange*: a stable argsort of the flat (token, choice) expert ids;
  3. *rank*: position within the expert = index - first occurrence
     (``searchsorted`` of the sorted ids against themselves);
  4. *keep* the assignments of rank < cap; the others write a drop row,
     which is discarded;
  5. *scatter* the tokens into the expert buffer, run the experts, then
     *gather* back and sum the k outputs weighted by the gates.

The port lays the expert buffer out as [E, g, cap, d], where the
reference has [g, E * cap + 1, d], so that one batched product per
weight covers every group with no permute; the slots that ``dispatch``
returns are the reference's group-local ones. The scatter into the
buffer and the gather back are an ``autograd.Function`` pair over two
maps that ``routes`` computes from the sorted expert ids: each kept
assignment's buffer row, and each buffer row's assignment (the inverse,
read off the sorted order: expert j's kept assignments are sorted
positions first_j .. first_j + min(count_j, cap) - 1). Kept rows are
unique, so both directions are gathers, the forward's and the
backward's alike: no scatter, no atomics and no run of equal ids added
one after another, on the CPU and the card. The reference's drop row
takes no row here: a dropped assignment reads zeros and its gradient is
0 on both sides, as the reference's scatter-``set`` gives its drop-row
writes no cotangent. The expert products are plain ``torch.bmm`` (the
reference's are ``jnp.einsum`` outside any Pallas kernel), and the rank
is ``torch.searchsorted`` as the reference's is ``jnp.searchsorted``.
Every shape follows from T, ``groups``, the capacity and k, so no step
reads the device from the host.

Inputs in float64 stay float64 throughout (the router included), which
the checks use as a reference.

On a mesh (x a DTensor), as the reference's ``maybe_shard`` points place
it: the group axis over the data axes ("dp"), so that routing stays
local to a device's groups. Route, dispatch and combine run under
``local_map`` over the groups (``argsort``, ``topk`` and
``searchsorted`` have no DTensor rules), and the expert products are
DTensor ``bmm``s on the expert weights' layout: experts over "model"
(the buffer's move to them, and back for the combine, are the
collectives) or each expert's d_ff over it. The load-balancing loss is a
partial sum over the groups' devices.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import (
    act_fn, maybe_shard, normal_init, redistributed,
)


class MoEConfig(NamedTuple):
    n_experts: int
    top_k: int
    d_ff: int                  # per-expert hidden
    capacity_factor: float = 1.25
    act: str = "silu"
    glu: bool = True


def param_shapes(cfg: MoEConfig, d_model: int) -> dict:
    """name -> (shape, init std) of one layer's MoE weights: the router
    [d, E] and the experts' [E, d, f] / [E, f, d] matrices."""
    e, f = cfg.n_experts, cfg.d_ff
    s_in, s_out = d_model ** -0.5, f ** -0.5
    shapes = {"router": ((d_model, e), s_in),
              "w_in": ((e, d_model, f), s_in),
              "w_out": ((e, f, d_model), s_out)}
    if cfg.glu:
        shapes["w_gate"] = ((e, d_model, f), s_in)
    return shapes


def init_moe(cfg: MoEConfig, d_model: int, dtype: torch.dtype,
             generator: torch.Generator, device=None) -> dict:
    """One layer's MoE weights, N(0, std) in ``dtype``."""
    return {name: normal_init(shape, std, dtype, generator, device)
            for name, (shape, std) in param_shapes(cfg, d_model).items()}


def group_plan(t: int, groups: int, cfg: MoEConfig) -> tuple:
    """(g, tg, cap) for ``t`` tokens, from shapes alone: g the largest
    divisor of t that is <= ``groups`` (decode batches can be tiny), tg =
    t / g tokens a group, cap the assignments an expert takes a group."""
    g = max(v for v in range(1, min(groups, t) + 1) if t % v == 0)
    tg = t // g
    cap = int(max(1, (tg * cfg.top_k * cfg.capacity_factor)
                  // cfg.n_experts))
    return g, tg, cap


def route(router: torch.Tensor, x: torch.Tensor, top_k: int):
    """x [..., d] -> (probs [..., E], top_p [..., k], top_e [..., k]):
    softmax of the router logits, computed in float32 (float64 stays
    float64), its k largest and their experts, top_p renormalised to sum
    to 1. TF32 is refused on the card: it would flip expert choices near
    ties."""
    if x.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("moe route: TF32 matmuls are allowed "
                           "(torch.backends.cuda.matmul.allow_tf32); the "
                           "router must be float32")
    ct = torch.promote_types(x.dtype, torch.float32)
    probs = torch.softmax(x.to(ct) @ router.to(ct), dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_e


def _arrange(top_e: torch.Tensor):
    """top_e [g, tg, k] -> (order, sorted_e, rank), each [g, tg * k]: the
    stable argsort of the flat (token, choice) expert ids, the ids in that
    order, and each assignment's rank within its expert (in token
    order)."""
    g, tg, k = top_e.shape
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(tg * k, device=top_e.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    return order, sorted_e, rank


def dispatch(top_p: torch.Tensor, top_e: torch.Tensor, n_experts: int,
             cap: int, dtype: torch.dtype):
    """top_p, top_e [g, tg, k] -> (slot, keep, gates), each [g, tg * k]
    in (token, choice) order within its group: an assignment's rank
    within its expert (stable in token order), kept if < cap; slot e *
    cap + rank if kept, else the drop row E * cap; gates top_p * keep in
    ``dtype``."""
    g, tg, k = top_e.shape
    _, _, rank = _arrange(top_e)
    keep = rank < cap
    slot = torch.where(keep, top_e.reshape(g, tg * k) * cap + rank,
                       n_experts * cap)
    gates = (top_p.reshape(g, tg * k) * keep).to(dtype)
    return slot, keep, gates


class Routes(NamedTuple):
    """Where each assignment goes in the [E, g, cap] buffer, and back.
    Assignments are flat over (group, token, choice), [T * k]; buffer
    rows are flat over (expert, group, rank), [E * g * cap]."""
    row: torch.Tensor       # [T k] the assignment's row (0 when dropped)
    keep: torch.Tensor      # [T k] kept (rank < cap)
    gates: torch.Tensor     # [g, tg k] top_p * keep
    src: torch.Tensor       # [E g cap] the assignment filling the row
    filled: torch.Tensor    # [E g cap] whether one does


def routes(top_p: torch.Tensor, top_e: torch.Tensor, n_experts: int,
           cap: int, dtype: torch.dtype) -> Routes:
    """``dispatch``'s choice of kept assignments, as the two maps of the
    dispatch and combine: each kept assignment's row (expert j, group,
    rank r) -> (j g + group) cap + r, and each row's assignment, read off
    the sorted order (expert j's first cap sorted positions), with
    ``filled`` false past expert j's count."""
    g, tg, k = top_e.shape
    e, dev = n_experts, top_e.device
    order, sorted_e, rank = _arrange(top_e)
    keep = rank < cap
    gates = (top_p.reshape(g, tg * k) * keep).to(dtype)
    group = torch.arange(g, device=dev)[:, None]
    row = (top_e.reshape(g, tg * k) * g + group) * cap + rank
    row = torch.where(keep, row, 0).reshape(g * tg * k)
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    first = torch.searchsorted(sorted_e, experts, side="left")     # [g, E]
    end = torch.searchsorted(sorted_e, experts, side="right")
    pos = first[..., None] + torch.arange(cap, device=dev)  # [g, E, cap]
    filled = pos < end[..., None]
    src = torch.gather(order, 1, pos.clamp_max(tg * k - 1).reshape(g, -1))
    src = src.reshape(g, e, cap) + group[..., None] * (tg * k)
    return Routes(row, keep.reshape(g * tg * k), gates,
                  src.transpose(0, 1).reshape(-1),
                  filled.transpose(0, 1).reshape(-1))


def _gather_rows(x: torch.Tensor, index: torch.Tensor,
                 live: torch.Tensor) -> torch.Tensor:
    """Row index[i] of x [N, d] where live[i], else zeros: [len(index), d]."""
    return x.index_select(0, index).masked_fill_(~live[:, None], 0)


class _Dispatch(torch.autograd.Function):
    """Tokens x [T, d] -> the expert buffer [E g cap, d], row r holding
    token src[r] // k (zeros where unfilled). Backward: each kept
    assignment reads its row's gradient, summed over a token's k
    choices."""

    @staticmethod
    def forward(ctx, x, r: Routes, k: int):
        ctx.save_for_backward(r.row, r.keep)
        ctx.k = k
        return _gather_rows(x, torch.div(r.src, k, rounding_mode="floor"),
                            r.filled)

    @staticmethod
    def backward(ctx, grad):
        row, keep = ctx.saved_tensors
        gx = _gather_rows(grad.contiguous(), row, keep)
        return gx.view(-1, ctx.k, gx.shape[-1]).sum(dim=1), None, None


class _Combine(torch.autograd.Function):
    """The experts' output [E g cap, d] -> each assignment's row [T k, d]
    (zeros where dropped). Backward: each filled row reads its
    assignment's gradient."""

    @staticmethod
    def forward(ctx, out, r: Routes):
        ctx.save_for_backward(r.src, r.filled)
        return _gather_rows(out, r.row, r.keep)

    @staticmethod
    def backward(ctx, grad):
        src, filled = ctx.saved_tensors
        return _gather_rows(grad.contiguous(), src, filled), None


def mix(params, x: torch.Tensor, top_p: torch.Tensor, top_e: torch.Tensor,
        cfg: MoEConfig, cap: int) -> torch.Tensor:
    """The experts' output [T, d] for tokens x [T, d] routed to top_e
    with weights top_p (both [g, tg, k]): the dispatch into the [E, g,
    cap, d] buffer, the (gated) expert FFN as batched products, the
    combine and the gate-weighted sum over the k choices; differentiable
    in x, top_p and the weights."""
    t, d = x.shape
    g = top_e.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    r = routes(top_p, top_e, e, cap, x.dtype)
    xin = _Dispatch.apply(x, r, k).view(e, g * cap, d)
    h = torch.bmm(xin, params["w_in"])
    act = act_fn(cfg.act)
    if cfg.glu:
        h = act(torch.bmm(xin, params["w_gate"])) * h
    else:
        h = act(h)
    out = torch.bmm(h, params["w_out"]).view(e * g * cap, d)
    y = _Combine.apply(out, r) * r.gates.reshape(t * k, 1)
    return y.view(t, k, d).sum(dim=1)


def load_balance(probs: torch.Tensor, top_e: torch.Tensor,
                 n_experts: int) -> torch.Tensor:
    """The reference's aux loss from probs [g, tg, E] and top_e [g, tg,
    k]: E * sum(top-1 share * mean prob) a group, averaged over groups.
    A group's sum over experts of (tokens whose first choice is e / tg)
    * mean prob of e is the mean over its tokens of the mean prob of
    their first choice, which needs no one-hot."""
    mean_p = probs.mean(1)                                   # [g, E]
    return n_experts * mean_p.gather(1, top_e[..., 0]).mean()


def moe_ffn(params, x: torch.Tensor, cfg: MoEConfig, groups: int = 1):
    """x [T, d] (tokens flattened) -> (y [T, d] in x's dtype, aux load-
    balance loss), routed in ``group_plan(T, groups, cfg)`` groups."""
    if isinstance(x, DTensor):
        return _moe_ffn_meshed(params, x, cfg, groups)
    t, d = x.shape
    g, tg, cap = group_plan(t, groups, cfg)
    probs, top_p, top_e = route(params["router"], x.reshape(g, tg, d),
                                cfg.top_k)
    y = mix(params, x, top_p, top_e, cfg, cap)
    return y, load_balance(probs, top_e, cfg.n_experts)


def _experts(params, xin, cfg: MoEConfig):
    """The (gated) expert FFN on the buffer [E, rows, d]: batched
    products."""
    h = torch.bmm(xin, params["w_in"])
    act = act_fn(cfg.act)
    if cfg.glu:
        h = act(torch.bmm(xin, params["w_gate"])) * h
    else:
        h = act(h)
    return torch.bmm(h, params["w_out"])


def _moe_ffn_meshed(params, x, cfg: MoEConfig, groups: int):
    """``moe_ffn`` on DTensors (see the module docstring): the same
    groups, routes and products, each device routing its own groups."""
    t, d = x.shape
    g, tg, cap = group_plan(t, groups, cfg)
    e, k = cfg.n_experts, cfg.top_k
    mesh = x.device_mesh
    # the tokens over the data axes only (a sequence split over "model"
    # would cut a group), and whole when the groups do not divide them
    names = mesh.mesh_dim_names
    rows = tuple(p if p == Shard(0) and names[i] != "model" else Replicate()
                 for i, p in enumerate(x.placements))
    if g % math.prod(mesh.size(i) for i, p in enumerate(rows)
                     if p == Shard(0)):
        rows = (Replicate(),) * mesh.ndim
    x = redistributed(x, rows)
    xg = maybe_shard(x.reshape(g, tg, d), "dp", None, None)
    at = tuple(p if p == Shard(0) else Replicate() for p in xg.placements)
    xg = redistributed(xg, at)
    whole = (Replicate(),) * mesh.ndim
    router = redistributed(params["router"], whole)
    by_group = tuple(Shard(1) if p == Shard(0) else p for p in at)
    aux_at = tuple(Partial() if p == Shard(0) else p for p in at)

    def route_and_dispatch(xl, rl):
        gl = xl.shape[0]
        probs, top_p, top_e = route(rl, xl, k)
        r = routes(top_p, top_e, e, cap, xl.dtype)
        xin = _Dispatch.apply(xl.reshape(gl * tg, d), r, k)
        aux = e * probs.mean(1).gather(1, top_e[..., 0]).sum() / (g * tg)
        return (xin.view(e, gl * cap, d), r.row, r.keep, r.gates,
                r.src.view(e, gl * cap), r.filled.view(e, gl * cap), aux)

    xin, row, keep, gates, src, filled, aux = local_map(
        route_and_dispatch,
        out_placements=(by_group, at, at, at, by_group, by_group, aux_at),
        in_placements=(at, whole), device_mesh=mesh)(xg, router)
    out = redistributed(_experts(params, xin, cfg), by_group)

    def combine(ol, row_l, keep_l, gates_l, src_l, filled_l):
        r = Routes(row_l, keep_l, gates_l, src_l.reshape(-1),
                   filled_l.reshape(-1))
        n = row_l.shape[0]
        y = _Combine.apply(ol.reshape(-1, d), r) * gates_l.reshape(n, 1)
        return y.view(n // k, k, d).sum(dim=1)

    y = local_map(combine, out_placements=list(at),
                  in_placements=(by_group, at, at, at, by_group, by_group),
                  device_mesh=mesh)(out, row, keep, gates, src, filled)
    return maybe_shard(y, "dp", None, None).reshape(t, d), aux
