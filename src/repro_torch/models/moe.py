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

The port lays the expert buffer out as [E, g, cap, d] with one drop row
after it, where the reference has [g, E * cap + 1, d], so that one
batched product per weight covers every group with no permute; the
slots that ``dispatch`` returns are the reference's group-local ones.
The expert products are plain ``torch.bmm`` (the reference's are
``jnp.einsum`` outside any Pallas kernel), and the rank is
``torch.searchsorted`` as the reference's is ``jnp.searchsorted``.
Every shape follows from T, ``groups``, the capacity and k, so no step
reads the device from the host.

Inputs in float64 stay float64 throughout (the router included), which
the checks use as a reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import act_fn, normal_init


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


def dispatch(top_p: torch.Tensor, top_e: torch.Tensor, n_experts: int,
             cap: int, dtype: torch.dtype):
    """top_p, top_e [g, tg, k] -> (slot, keep, gates), each [g, tg * k]
    in (token, choice) order within its group: an assignment's rank
    within its expert (stable in token order), kept if < cap; slot e *
    cap + rank if kept, else the drop row E * cap; gates top_p * keep in
    ``dtype``."""
    g, tg, k = top_e.shape
    flat_e = top_e.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank_sorted = torch.arange(tg * k, device=top_e.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, n_experts * cap)
    gates = (top_p.reshape(g, tg * k) * keep).to(dtype)
    return slot, keep, gates


def mix(params, x: torch.Tensor, top_p: torch.Tensor, top_e: torch.Tensor,
        cfg: MoEConfig, cap: int) -> torch.Tensor:
    """The experts' output [T, d] for tokens x [T, d] routed to top_e
    with weights top_p (both [g, tg, k]): dispatch, scatter into the
    [E, g, cap, d] buffer, the (gated) expert FFN as batched products,
    gather and the gate-weighted sum over the k choices."""
    t, d = x.shape
    g = top_e.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    slot, keep, gates = dispatch(top_p, top_e, e, cap, x.dtype)
    # group-local slot (expert j, rank r) -> row (j * g + group) * cap + r
    # of the [E, g, cap] buffer; drops -> its last row
    rows = e * g * cap
    expert = torch.div(slot, cap, rounding_mode="floor")
    group = torch.arange(g, device=x.device)[:, None]
    row = torch.where(keep, slot + (expert * (g - 1) + group) * cap, rows)
    row = row.reshape(t * k)
    buf = x.new_zeros((rows + 1, d))
    buf.index_copy_(0, row, x[:, None].expand(t, k, d).reshape(t * k, d))
    xin = buf[:rows].view(e, g * cap, d)
    h = torch.bmm(xin, params["w_in"])
    act = act_fn(cfg.act)
    if cfg.glu:
        h = act(torch.bmm(xin, params["w_gate"])) * h
    else:
        h = act(h)
    out = x.new_empty((rows + 1, d))
    out[rows].zero_()
    torch.bmm(h, params["w_out"], out=out[:rows].view(e, g * cap, d))
    y = out.index_select(0, row) * gates.reshape(t * k, 1)
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
    t, d = x.shape
    g, tg, cap = group_plan(t, groups, cfg)
    probs, top_p, top_e = route(params["router"], x.reshape(g, tg, d),
                                cfg.top_k)
    y = mix(params, x, top_p, top_e, cfg, cap)
    return y, load_balance(probs, top_e, cfg.n_experts)
