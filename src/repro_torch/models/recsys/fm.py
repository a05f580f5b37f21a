"""Factorization Machine [Rendle, ICDM'10], after
``repro.models.recsys.fm``: Criteo-style layout, 39 sparse fields over
one hashed embedding table, the FM 2-way interaction by the O(nk)
sum-square trick, plus the linear term.

The interaction runs through ``kernels.fm_interaction``: the
hand-written CUDA kernel on a CUDA device, its plain torch version on
the CPU. Each example's gathered factor rows [F, k] are its factor
matrix, with x = 1 for every field (one-hot fields); the reference's
``jax.vmap`` of the kernel over examples is the kernel's batch
dimension here. ``FMConfig`` has no ``backend``: the device picks the
kernel, whatever the reference's ``backend`` would have said (its
"xla" and Pallas paths compute the same function).

``embedding_bag`` (multi-hot fields) is a clipped gather plus the
sorted-segment sum kernel (``kernels.segment_reduce``).

Ids are gathered as ``jnp.take(..., mode="clip")`` does: cast to int32,
then clamped to [0, vocab - 1] (a negative id reads row 0, not a row
from the end).

Training (``FM(..., train=True)``, ``loss_fn`` with gradients): the
interaction's gradient is the kernel's backward entry
(``kernels.fm_interaction``); the scatter of the gathered rows'
gradients into the tables is autograd's ``index_select`` backward, which
is deterministic on the card under
``torch.use_deterministic_algorithms(True)`` (the training launcher sets
it). ``param_tree()`` is the reference's {"v", "w", "b"} sharing storage
with the parameters; ``grad_tree()`` zeroed gradient buffers wired as
their ``.grad``. A serving ``FM`` (the default) is frozen.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import fm_interaction as FI
from repro_torch.kernels import segment_reduce as SR
from repro_torch.models.common import (
    normal_init, parameter, redistributed, resolve_device, settle,
    wire_grads,
)


class FMConfig(NamedTuple):
    n_fields: int = 39
    embed_dim: int = 10
    vocab: int = 4_000_000       # hashed joint table (rows)


def init_params(cfg: FMConfig, generator: torch.Generator,
                device=None) -> dict:
    """{"v": [vocab, k], "w": [vocab, 1], "b": 0-d} in float32: v and w
    from Normal(0, 0.01) drawn from ``generator`` (on its device unless
    ``device`` says), b = 0."""
    device = generator.device if device is None else torch.device(device)

    def draw(shape):
        return normal_init(shape, 0.01, torch.float32, generator, device)

    return {"v": draw((cfg.vocab, cfg.embed_dim)),
            "w": draw((cfg.vocab, 1)),
            "b": torch.zeros((), dtype=torch.float32, device=device)}


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's {"v", "w", "b"} as numpy arrays -> float32 tensors
    on ``device``."""
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in ("v", "w", "b")}


def take_clip(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (any shape) -> [*ids.shape, d], as
    ``jnp.take(table, ids.astype(int32), axis=0, mode="clip")``. A DTensor
    table (its rows over "model") is looked up vocab-parallel
    (``F.embedding``: each device its rows, then the partial sums
    reduced)."""
    idx = ids.to(torch.int32).clamp(0, table.shape[0] - 1)
    if isinstance(table, DTensor):
        return settle(F.embedding(idx.long(), table))
    rows = table.index_select(0, idx.reshape(-1))
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ``ids`` [n] row indices (clipped), ``bag_ids`` [n]
    sorted bag of each id -> [n_bags, d]; an empty bag gives 0. "mean"
    divides each bag's sum by its size."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"embedding_bag: mode {mode!r}")
    bag_ids = bag_ids.to(torch.int32).contiguous()
    out = SR.segment_reduce(take_clip(table, ids), bag_ids, n_bags, "sum")
    if mode == "mean":
        ones = torch.ones((ids.shape[0], 1), dtype=torch.float32,
                          device=table.device)
        cnt = SR.segment_reduce(ones, bag_ids, n_bags, "sum")
        out = out / torch.clamp_min(cnt, 1.0)
    return out


def _interaction(v: torch.Tensor) -> torch.Tensor:
    """The FM interaction of v [B, F, k] with unit values, through the
    kernel; on a DTensor through ``local_map`` over its batch shard."""
    def one(vl):
        x = torch.ones((1, 1), dtype=vl.dtype, device=vl.device)
        return FI.fm_interaction(x.expand(vl.shape[0], vl.shape[1]), vl)
    if not isinstance(v, DTensor):
        return one(v)
    at = tuple(p if p == Shard(0) else Replicate() for p in v.placements)
    v = redistributed(v, at)
    return local_map(one, out_placements=list(at), in_placements=(at,),
                     device_mesh=v.device_mesh)(v)


def _log_likelihood(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The log-likelihood of each 0/1 label under its logit."""
    return y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits)


class FM(nn.Module):
    """The FM model on ``device`` (default the card; raises when there
    is none), from ``params`` or from ``generator`` (default seed 0).

    The retrieval matvec is float32, as the reference computes it: on
    the card ``retrieval_scores`` raises if
    ``torch.backends.cuda.matmul.allow_tf32`` is set (it is False by
    default; the model does not change it)."""

    def __init__(self, cfg: FMConfig, params: Optional[dict] = None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "FM")
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, self.device)
        self._tree = {k: params[k].to(self.device) for k in ("v", "w", "b")}
        self._grads: Optional[dict] = None
        self.v = parameter(self._tree["v"], train)
        self.w = parameter(self._tree["w"], train)
        self.b = parameter(self._tree["b"], train)

    def param_tree(self) -> dict:
        """{"v", "w", "b"}, sharing storage with the parameters."""
        return self._tree

    @property
    def grads(self) -> Optional[dict]:
        """The gradient buffers of ``grad_tree`` as the last backward left
        them (None before the first ``grad_tree``)."""
        return self._grads

    def grad_tree(self) -> dict:
        """Zeroed gradient buffers {"v", "w", "b"} wired as the
        parameters' ``.grad``, which the next backward accumulates
        into."""
        if self._grads is None:
            self._grads = {k: torch.zeros_like(t)
                           for k, t in self._tree.items()}
        wire_grads((getattr(self, k), self._grads[k]) for k in self._tree)
        return self._grads

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device)

    def forward(self, ids) -> torch.Tensor:
        """ids [B, F] hashed feature ids -> logits [B]."""
        ids = self._ids(ids)
        B, nf = ids.shape
        v = take_clip(self.v, ids)                  # [B, F, k]
        w = take_clip(self.w, ids)[..., 0]          # [B, F]
        return self.b + w.sum(-1) + _interaction(v)

    def loss_fn(self, ids, labels) -> torch.Tensor:
        """Mean binary cross-entropy of the logits against 0/1 labels
        (with gradients when the model was built with ``train``)."""
        logits = self(ids)
        y = self._ids(labels).float()
        if not isinstance(logits, DTensor):
            return -_log_likelihood(logits, y).mean()
        # on a mesh each device takes its rows (DTensor has no rule for
        # logsigmoid's backward)
        at = [p if p == Shard(0) else Replicate() for p in logits.placements]
        mesh = logits.device_mesh
        logits, y = (redistributed(t, at) for t in (logits, y))
        return -local_map(_log_likelihood, out_placements=at,
                          in_placements=(at, at),
                          device_mesh=mesh)(logits, y).mean()

    def retrieval_scores(self, context_ids, candidate_ids) -> torch.Tensor:
        """context_ids [F] (one query), candidate_ids [C] -> scores [C]:
        the context's FM state (linear term, interaction, sum of its
        factors sv) plus each candidate's w_c + v_c . sv, one matvec."""
        tf32 = torch.backends.cuda.matmul.allow_tf32
        if self.device.type == "cuda" and tf32:
            raise RuntimeError("retrieval_scores: TF32 matmuls are allowed "
                               "(torch.backends.cuda.matmul.allow_tf32); the "
                               "matvec must be float32")
        vc = take_clip(self.v, self._ids(context_ids))       # [F, k]
        wc = take_clip(self.w, self._ids(context_ids))[..., 0]
        sv = vc.sum(0)
        s2 = (vc * vc).sum(0)
        base = self.b + wc.sum() + 0.5 * (sv * sv - s2).sum()
        cand = self._ids(candidate_ids)
        v_cand = take_clip(self.v, cand)                     # [C, k]
        w_cand = take_clip(self.w, cand)[..., 0]
        return base + w_cand + v_cand @ sv
