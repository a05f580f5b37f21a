"""AdamW with global-norm clipping and a warm-up/cosine schedule, after
``repro.training.optim``, on trees of tensors (nested dicts, leaves in
JAX's flatten order: dict keys sorted).

The arithmetic is the reference's, operation for operation: moments in
float32 whatever the parameter's dtype, the step's clipped gradient
rounded back to the gradient's dtype before it is used, the update
``mhat / (sqrt(vhat) + eps) + wd * p`` in float32, and the new parameter
rounded once to its dtype. ``torch.optim.AdamW`` orders its epsilon,
decay and bias corrections otherwise, so it is not used.

Unlike the reference, whose update returns new arrays, ``adamw_update``
writes the parameters and both moments in place (a second copy of a
1.7B-parameter model's state would take another 17 GB on the card), one
leaf at a time and a large leaf in slices of its first axis of at most
``CHUNK`` elements, so its float32 temporaries (about four of the slice's
size at the peak) stay near a gigabyte: a whole stacked leaf's took 22 GB
at chatglm3-6b's 25 layers ([25, 4096, 13696] FFN leaves) and ran the
card out of memory. The arithmetic is elementwise, so the slices give
the same bits as the whole leaf. The step
counter, the schedule and the clipping scale stay on the tensors' device:
no host read.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


class TrainState(NamedTuple):
    params: Any             # a tree of tensors
    mu: Any                 # float32, params' tree
    nu: Any
    step: torch.Tensor      # int32, 0-d


def tree_leaves(tree) -> list:
    """Leaves in JAX's flatten order (dict keys sorted; None is empty)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, trees of the
    same structure), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params) -> tuple[Any, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return tree_map(zeros, params), tree_map(zeros, params)


def train_state_init(params) -> TrainState:
    """The state of step 0 over ``params`` (kept, not copied: a model
    whose parameters share their storage sees every update)."""
    mu, nu = adamw_init(params)
    device = tree_leaves(params)[0].device
    return TrainState(params, mu, nu,
                      torch.zeros((), dtype=torch.int32, device=device))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a float32 tensor): linear warm-up to
    ``lr``, then a cosine down to a tenth of it at ``total_steps``."""
    dev = step.device
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0, dev))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's sum
    of squares, in float32. Each leaf is squared in a float32 copy of
    its own, in place: one leaf-sized temporary, not two (the optimizer
    step's peak on the card, 5.6 GB a [25, 4096, 13696] bf16 leaf), the
    same values and so the same sums."""
    return torch.sqrt(sum(
        torch.sum(g.to(torch.float32, copy=True).square_())
        for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each
    rounded back to its dtype; the norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: _clipped(g, scale), grads), gn


@torch.no_grad()
def adamw_update(state: TrainState, grads, cfg: AdamWConfig
                 ) -> tuple[TrainState, torch.Tensor]:
    """One AdamW step of ``state`` by ``grads`` (the params' tree),
    clipped by global norm: writes ``state``'s parameters and moments in
    place and returns (the state with the next step, the gradients'
    global norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, cfg.clip_norm)
    step = state.step + 1
    t = step.float()
    lr = schedule(cfg, t)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1, t.device) ** t
    bc2 = 1 - _f32(b2, t.device) ** t
    leaves = zip(tree_leaves(state.params), tree_leaves(grads),
                 tree_leaves(state.mu), tree_leaves(state.nu))
    for leaf in leaves:
        for p, g, m, v in _slices(*leaf):
            g32 = _clipped(g, scale).float()
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_((g32 * (1 - b2)).mul_(g32))
            del g32
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            p32 = p.float()
            delta.add_(cfg.weight_decay * p32)
            p.copy_(p32 - lr * delta)
    return TrainState(state.params, state.mu, state.nu, step), gn


CHUNK = 1 << 26     # elements of a leaf's slice in adamw_update


def _slices(*leaf):
    """The leaf's tensors (parameter, gradient, moments; one shape) as
    views of slices of their first axis, each of at most CHUNK elements
    where a row allows (a row is never split); a small leaf whole."""
    p = leaf[0]
    if p.numel() <= CHUNK or p.dim() == 0:
        return [leaf]
    rows = max(1, CHUNK // max(1, p[0].numel()))
    return [tuple(t[i:i + rows] for t in leaf)
            for i in range(0, p.shape[0], rows)]
