"""Decoder-only transformer LM, after ``repro.models.transformer``.

Covers every LM config of the reference: GQA KV-head count, head_dim
override (gemma's 256), GeGLU/SwiGLU, qk-norm (qwen3), partial rotary
(chatglm3's 2d RoPE), tied or untied embeddings, and a dense or MoE FFN
(granite; ``models/moe.py``). A ``Transformer`` is an
``nn.Module`` of per-layer ``Block``s with four entry points,
``forward`` (logits for every position), ``prefill`` (last-position
logits and the KV cache), ``decode_step`` (one token against the cache)
and ``loss_fn`` (the training loss, with gradients: the cross-entropy
plus 0.01 times the MoE layers' load-balance losses, as the
reference's).

Attention runs through ``kernels.flash_attention`` (prefill and
training) and ``kernels.flash_decode`` (decode): the hand-written CUDA
kernels on a CUDA device, their plain torch versions on the CPU. The
projections, the FFN and the unembedding are plain matmuls (``x @ w`` on
``[in, out]`` weights, the reference's layout); the MoE FFN is
``moe.moe_ffn``, called through its module so that a caller may wrap it.

Parameters and the reference's layout: the model is built from the
reference's tree (every per-layer leaf stacked [L, ...], the MoE's under
``layers["moe"]``), and each ``Block``'s parameters are views of layer i
of those stacked tensors, so ``param_tree()`` is that tree, sharing
storage with the module, and an optimizer that updates it in place
updates the model. ``grad_tree()`` gives the gradients in the same
layout: zeroed stacked buffers whose layer views are the parameters'
``.grad``, into which backward accumulates. Training state, checkpoints
and the CPU comparison with the reference all use that layout and its
leaf order.

``TransformerConfig`` keeps the fields that define the model, and
``remat``: under ``loss_fn`` each ``Block`` then runs under
``torch.utils.checkpoint`` (its activations recomputed in the backward),
as the reference's ``jax.checkpoint`` of its layer body. The reference's
``attn_backend`` is gone (the device picks the kernel), and so is
``scan_layers`` (a TPU compile option). ``moe_groups`` stays: the MoE
routes each of its token groups on its own, so the group count decides
which tokens exceed an expert's capacity and drop.

On a mesh. A model whose parameter tree holds DTensors (laid out by
``configs.base.place`` and an arch's ``shardings``) runs on the mesh when
its inputs are DTensors too, under ``launch.mesh.use_mesh``: the
projections and FFN are DTensor matmuls, the embedding a vocab-parallel
``F.embedding``, and plain tensors mixed in (positions, masks) count as
replicated. The layout fields ``seq_parallel`` (the residual stream's
sequence over "model") and ``batch_shard_all`` (FSDP: the batch over
every axis, ``_fsdp_shard``) place the reference's ``maybe_shard``
constraints. Attention runs through ``local_map`` with the heads on
"model" and the batch where it lies, so the prefill and decode kernels
run on each device's local heads (``_attend``, ``_attend_decode``); KV
heads that do not divide "model" stay whole, and each device takes the
ones its query heads read. The decode writes the token's K and V into
each device's shard of the cache in place. Without a mesh nothing of
this runs.

Unlike the reference, whose functions return new arrays, ``decode_step``
writes the new token's K and V into the cache in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import moe
from repro_torch.models.common import (
    act_fn, active_abstract_mesh, apply_rope, cross_entropy_loss,
    dt_zeros, grad_placed, matmul, maybe_shard, mesh_axes, normal_init,
    parameter, redistributed, replicated, resolve_device, rms_norm,
    rope_angles, settle, wire_grads,
)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    act: str = "silu"
    glu: bool = True
    qk_norm: bool = False
    rope_fraction: float = 1.0               # chatglm3: 0.5 ('RoPE 2d')
    rope_theta: float = 10000.0
    moe: Optional[moe.MoEConfig] = None
    moe_groups: int = 32                     # GShard group axis
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True                       # recompute layers in backward
    seq_parallel: bool = False               # Megatron-SP: residual stream
                                             # sequence-sharded over 'model'
    batch_shard_all: bool = False            # FSDP: batch sharded over ALL
                                             # mesh axes
    logit_softcap: float = 0.0               # gemma-style soft capping

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a 128 multiple; logits beyond
        ``vocab`` are masked."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def rot_dim(self) -> int:
        r = int(self.hd * self.rope_fraction)
        return r - (r % 2)

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def param_count(self) -> int:
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe:
            ff = self.moe.n_experts * d * self.moe.d_ff * (
                3 if self.moe.glu else 2) + d * self.moe.n_experts
        else:
            ff = d * self.d_ff * (3 if self.glu else 2)
        per_layer = attn + ff + 2 * d
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + d

    def active_param_count(self) -> int:
        """FLOP-relevant parameters (MoE: top-k experts only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        attn = d * self.hd * (self.n_heads * 2 + self.n_kv_heads * 2)
        ff = self.moe.top_k * d * self.moe.d_ff * (
            3 if self.moe.glu else 2) + d * self.moe.n_experts
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + 2 * d) + embed + d


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, hkv, S, hd]
    v: torch.Tensor
    length: torch.Tensor  # [B] int32


def _layer_shapes(cfg: TransformerConfig) -> dict:
    """name -> (shape, init std or None for a zero norm) of one layer's
    weights; the MoE's under "moe", a dict of the same form."""
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    shapes = {
        "wq": ((d, cfg.n_heads * hd), d ** -0.5),
        "wk": ((d, cfg.n_kv_heads * hd), d ** -0.5),
        "wv": ((d, cfg.n_kv_heads * hd), d ** -0.5),
        "wo": ((cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
        "ln1": ((d,), None),
        "ln2": ((d,), None),
    }
    if cfg.qk_norm:
        shapes["qnorm"] = ((hd,), None)
        shapes["knorm"] = ((hd,), None)
    if cfg.moe:
        shapes["moe"] = moe.param_shapes(cfg.moe, d)
        return shapes
    shapes["w_in"] = ((d, f), d ** -0.5)
    shapes["w_out"] = ((f, d), f ** -0.5)
    if cfg.glu:
        shapes["w_gate"] = ((d, f), d ** -0.5)
    return shapes


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a parameter tree (nested
    dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's parameter tree with its distributions and scales:
    every per-layer leaf stacked [L, ...] (the MoE's under
    ``layers["moe"]``); norms zero (they scale by 1 + gamma); the
    embedding N(0, 1), [vocab_padded, d]."""
    device = generator.device if device is None else torch.device(device)
    dt, L, d = cfg.compute_dtype, cfg.n_layers, cfg.d_model

    def draw(shape, std):
        if std is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return normal_init(shape, std, dt, generator, device)

    def draw_layers(shapes):
        return {name: (draw_layers(spec) if isinstance(spec, dict)
                       else draw((L,) + spec[0], spec[1]))
                for name, spec in shapes.items()}

    layers = draw_layers(_layer_shapes(cfg))
    params = {"embed": draw((cfg.vocab_padded, d), 1.0),
              "ln_f": draw((d,), None), "layers": layers}
    if not cfg.tie_embeddings:
        params["unembed"] = draw((d, cfg.vocab_padded), d ** -0.5)
    return params


def _tensor_from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy array (bfloat16 from ml_dtypes included, which is read as
    its 2-byte payload, so ml_dtypes need not be installed) -> tensor."""
    a = np.array(a)         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cuda") -> dict:
    """The reference's parameter tree as numpy arrays (stacked [L, ...]
    layer leaves, the MoE's under ``layers["moe"]``) -> the tree of
    tensors a ``Transformer`` takes, in the config's dtype on
    ``device``."""
    dt = cfg.compute_dtype
    return tree_map(lambda a: _tensor_from_numpy(a, dt, device), tree)


class Block(nn.Module):
    """One pre-norm decoder layer: attention, then the (gated) FFN, dense
    or MoE (its weights in ``moe_weights``); trainable when ``train``."""

    def __init__(self, cfg: TransformerConfig, weights: dict,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        for name in _layer_shapes(cfg):
            if name == "moe":
                self.moe_weights = nn.ParameterDict(
                    {k: parameter(w, train)
                     for k, w in weights["moe"].items()})
            else:
                setattr(self, name, parameter(weights[name], train))

    def forward(self, x, sin, cos, cache_kv=None, pos=None, layout=None):
        """x [B, S, d]. Prefill (no cache): returns (y, (k, v), aux) with
        k, v [B, hkv, S, hd]. Decode (S = 1): writes k, v at ``pos`` [B]
        of the cache (k, v) [B, hkv, Scap, hd] and attends over pos + 1
        positions; returns (y, cache_kv, aux). aux is the MoE's
        load-balancing loss (float32), None for a dense FFN. ``layout``
        (default the config) gives ``seq_parallel`` and
        ``batch_shard_all``, which shard the residual stream on a mesh
        (``_constrain``)."""
        cfg = self.cfg
        layout = cfg if layout is None else layout
        B, S, _ = x.shape
        hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        h = rms_norm(x, self.ln1)
        q = _heads(matmul(h, self.wq), hq, hd)
        k = _heads(matmul(h, self.wk), hkv, hd)
        v = _heads(matmul(h, self.wv), hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
            k = rms_norm(k, self.knorm)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        prefill = cache_kv is None
        x = _constrain(x, layout, prefill)
        if not prefill:
            ck, cv = cache_kv
            _scatter_kv(ck, k[:, 0], pos)
            _scatter_kv(cv, v[:, 0], pos)
            attn = _attend_decode(q[:, 0].contiguous(), ck, cv, pos + 1)
            new_kv = cache_kv
        else:
            kt = k.transpose(1, 2).contiguous()
            vt = v.transpose(1, 2).contiguous()
            attn = _attend(q.transpose(1, 2).contiguous(), kt,
                           vt).transpose(1, 2)
            new_kv = (kt, vt)
        attn = grad_placed(attn.reshape(B, S, hq * hd))
        x = _constrain(x + settle(matmul(attn, self.wo)), layout, prefill)
        h2 = rms_norm(x, self.ln2)
        if cfg.moe:
            y, aux = moe.moe_ffn(self.moe_weights, h2.reshape(B * S, -1),
                                 cfg.moe, groups=cfg.moe_groups)
            return (_constrain(x + y.reshape(B, S, -1), layout, prefill),
                    new_kv, aux)
        up = matmul(h2, self.w_in)
        if cfg.glu:
            up = act_fn(cfg.act)(matmul(h2, self.w_gate)) * up
        else:
            up = act_fn(cfg.act)(up)
        return (_constrain(x + settle(matmul(up, self.w_out)), layout, prefill),
                new_kv, None)


def _block_out(block: Block, x, sin, cos, layout=None):
    """(y, aux) of a block in training: what its checkpoint keeps."""
    y, _, aux = block(x, sin, cos, layout=layout)
    return y, aux


def _heads(t, n: int, hd: int):
    """[B, S, n hd] -> [B, S, n, hd]. A DTensor whose last dim is split
    over a mesh dim that does not divide n (qwen3's 8 KV heads on a
    16-way "model": the split runs inside a head) is gathered there
    first, since DTensor's view refuses such a split."""
    B, S, _ = t.shape
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        want = tuple(Replicate() if p == Shard(2) and n % mesh.size(i)
                     else p for i, p in enumerate(t.placements))
        t = redistributed(t, want)
    return t.reshape(B, S, n, hd)


def _constrain(x, layout: TransformerConfig, prefill: bool):
    """The reference's constraints on the residual stream x [B, S, d]
    (no-ops without a mesh, and in the decode): the sequence over
    "model" under ``seq_parallel``, the FSDP layout under
    ``batch_shard_all``."""
    if not prefill:
        return x
    if layout.seq_parallel:
        x = maybe_shard(x, "dp", "model", None)
    if layout.batch_shard_all:
        x = _fsdp_shard(x)
    return x


def _fsdp_shard(x):
    """FSDP activation layout: the batch over every mesh axis; when the
    batch does not divide (multi-pod, global batch < devices) the batch
    over (pod, data) and the sequence over "model" (DP x SP)."""
    mesh = active_abstract_mesh()
    if mesh is None:
        return x
    n_all = 1
    for v in mesh_axes(mesh).values():
        n_all *= v
    if x.shape[0] % n_all == 0:
        return maybe_shard(x, "all", None, None)
    return maybe_shard(x, "dp", "model", None)


def _head_layout(q, kvs, heads: tuple) -> tuple:
    """Placements of ``local_map``'s inputs for attention: q [B, hq, ...]
    and each of ``kvs`` [B, hkv, ...]. On each mesh dim: a dim of size 1
    keeps every input as it is (its shard is the whole tensor); the batch
    stays where q has it; "model" takes the heads of q, and of the kvs
    when hkv divides it too (else they stay whole); every other dim
    leaves them whole. ``heads`` is (hq, hkv)."""
    mesh = q.device_mesh
    hq, hkv = heads
    qp, kp = [], [[] for _ in kvs]
    for i, name in enumerate(mesh.mesh_dim_names):
        m = mesh.size(i)
        if m == 1:
            qp.append(q.placements[i])
            for out, t in zip(kp, kvs):
                out.append(t.placements[i])
            continue
        if q.placements[i] == Shard(0):
            q_at = kv_at = Shard(0)
        elif name == "model" and hq % m == 0:
            q_at = Shard(1)
            kv_at = Shard(1) if hkv % m == 0 else Replicate()
        else:
            q_at = kv_at = Replicate()
        qp.append(q_at)
        for out in kp:
            out.append(kv_at)
    return tuple(qp), tuple(tuple(p) for p in kp)


def _local_kv_heads(q_local, kv_local, mesh, q_at, heads):
    """The KV heads that a device's query heads read when the KV heads
    stay whole on "model" while the query heads are split over it: one
    KV head for each local query head (so the local call is MHA)."""
    hq, hkv = heads
    for i, p in enumerate(q_at):
        if p == Shard(1) and mesh.size(i) > 1 and hkv % mesh.size(i):
            n = q_local.shape[1]
            first = mesh.get_local_rank(i) * n
            ids = (first + torch.arange(n, device=q_local.device)) // (
                hq // hkv)
            return [t.index_select(1, ids) for t in kv_local]
    return kv_local


def _attend(q, k, v):
    """Causal attention q [B, hq, S, hd], k, v [B, hkv, S, hd] ->
    [B, hq, S, hd] through ``kernels.flash_attention``; on DTensors
    through ``local_map`` (``_head_layout``)."""
    if not isinstance(q, DTensor):
        return FA.flash_attention(q, k, v, causal=True)
    heads = (q.shape[1], k.shape[1])
    q_at, (k_at, v_at) = _head_layout(q, (k, v), heads)
    mesh = q.device_mesh

    def local(ql, kl, vl):
        kl, vl = _local_kv_heads(ql, (kl, vl), mesh, q_at, heads)
        return FA.flash_attention(ql, kl.contiguous(), vl.contiguous(),
                                  causal=True)
    return local_map(local, out_placements=list(q_at),
                     in_placements=(q_at, k_at, v_at), device_mesh=mesh)(
        redistributed(q, q_at), redistributed(k, k_at),
        redistributed(v, v_at))


def _attend_decode(q, ck, cv, lengths):
    """One-token attention q [B, hq, hd] over the cache ck, cv [B, hkv,
    S, hd] at ``lengths`` [B] through ``kernels.flash_decode``; on
    DTensors through ``local_map`` (``_head_layout``: the cache is
    redistributed to the heads where it lies elsewhere)."""
    if not isinstance(q, DTensor):
        return FA.flash_decode(q, ck, cv, lengths)
    heads = (q.shape[1], ck.shape[1])
    q_at, (k_at, v_at, n_at) = _head_layout(q, (ck, cv, lengths), heads)
    n_at = tuple(p if p == Shard(0) or p.is_replicate() else Replicate()
                 for p in n_at)
    mesh = q.device_mesh

    def local(ql, kl, vl, nl):
        kl, vl = _local_kv_heads(ql, (kl, vl), mesh, q_at, heads)
        return FA.flash_decode(ql, kl.contiguous(), vl.contiguous(), nl)
    return local_map(local, out_placements=list(q_at),
                     in_placements=(q_at, k_at, v_at, n_at),
                     device_mesh=mesh)(
        redistributed(q, q_at), redistributed(ck, k_at),
        redistributed(cv, v_at), redistributed(lengths, n_at))


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache [B, h, S, hd] += new [B, h, hd] at position pos[b] of each
    row, in place. As the reference's one-hot add, a position >= S is
    dropped, without a host read. A DTensor cache is written in its own
    layout: each device adds into its shard the rows and positions that
    fall in it."""
    if isinstance(cache, DTensor):
        _scatter_kv_sharded(cache, new, pos)
        return
    B, _, S, _ = cache.shape
    rows = torch.arange(B, device=cache.device)
    keep = (pos < S).to(new.dtype)[:, None, None]
    idx = pos.clamp(max=S - 1).long()
    cache[rows, :, idx, :] += new * keep


def _scatter_kv_sharded(cache, new, pos) -> None:
    """``_scatter_kv`` into each device's shard of a DTensor cache: the
    new rows and positions brought to the cache's batch and heads layout
    (whole elsewhere), the positions shifted by the shard's offset, and
    those outside it dropped."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    mesh = cache.device_mesh
    new_at = tuple(p if p in (Shard(0), Shard(1)) else Replicate()
                   for p in cache.placements)
    pos_at = tuple(p if p == Shard(0) else Replicate()
                   for p in cache.placements)
    local_new = redistributed(new, new_at).to_local()
    local_pos = redistributed(pos, pos_at).to_local()
    local = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    S = local.shape[2]
    shifted = local_pos.long() - offset[2]
    rows = torch.arange(local.shape[0], device=local.device)
    keep = ((shifted >= 0) & (shifted < S) & (local_pos < cache.shape[2]))
    keep = keep.to(local_new.dtype)[:, None, None]
    local[rows, :, shifted.clamp(0, S - 1), :] += local_new * keep


class Transformer(nn.Module):
    """The LM. ``params`` is a tree from ``init_params`` or
    ``params_from_numpy`` (kept, not copied, when it is on ``device``);
    without one, weights are drawn by ``init_params`` from ``generator``
    (seed 0 when None). Runs on ``device`` (default the card; raises
    when there is none). ``train`` makes the parameters trainable."""

    def __init__(self, cfg: TransformerConfig, params: Optional[dict] = None,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 train: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device, "Transformer")
        if params is None:
            if generator is None:
                generator = torch.Generator(self.device).manual_seed(0)
            params = init_params(cfg, generator, self.device)
        self._tree = tree_map(lambda t: t.to(self.device), params)
        self._grads: Optional[dict] = None
        params = self._tree
        self.embed = parameter(params["embed"], train)
        self.ln_f = parameter(params["ln_f"], train)
        self.unembed = (None if cfg.tie_embeddings
                        else parameter(params["unembed"], train))
        self.layers = nn.ModuleList(
            Block(cfg, tree_map(lambda t: t[i], params["layers"]), train)
            for i in range(cfg.n_layers))

    # -- the reference's layout ---------------------------------------------
    def param_tree(self) -> dict:
        """The reference's parameter tree (stacked [L, ...] layer leaves),
        sharing storage with this module's parameters."""
        return self._tree

    def _pairs(self, tree: dict):
        """(parameter, the tensor at its place in ``tree``) for every
        parameter; a block's are layer i of the stacked leaves."""
        yield self.embed, tree["embed"]
        yield self.ln_f, tree["ln_f"]
        if self.unembed is not None:
            yield self.unembed, tree["unembed"]
        for i, block in enumerate(self.layers):
            for name, leaf in tree["layers"].items():
                if name == "moe":
                    for k, w in leaf.items():
                        yield block.moe_weights[k], w[i]
                else:
                    yield getattr(block, name), leaf[i]

    @property
    def grads(self) -> Optional[dict]:
        """The gradient buffers of ``grad_tree`` as the last backward left
        them (None before the first ``grad_tree``)."""
        return self._grads

    def grad_tree(self) -> dict:
        """Zeroed gradient buffers in the reference's layout, wired as the
        parameters' ``.grad`` (layer i of a stacked buffer is block i's),
        so that the next backward accumulates into them."""
        if self._grads is None:
            self._grads = tree_map(torch.zeros_like, self._tree)
        wire_grads(self._pairs(self._grads))
        return self._grads

    # -- pieces shared by the entry points ----------------------------------
    @property
    def meshed(self) -> bool:
        """Whether the parameters are DTensors (the model runs on their
        mesh)."""
        return isinstance(self.embed, DTensor)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.meshed:
            # vocab-parallel on the mesh: each device looks up the rows it
            # holds and the partial sums are reduced
            x = settle(F.embedding(tokens.long(), self.embed))
        else:
            x = self.embed[tokens.to(self.device).long()]
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _angles(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_angles(positions, cfg.hd, cfg.rope_theta, cfg.rot_dim)

    def _prompt_angles(self, S: int):
        """RoPE angles of positions 0 .. S - 1 (replicated on a mesh)."""
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        if self.meshed:
            positions = replicated(positions, self.embed)
        return self._angles(positions[None, :])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        unembed = self.embed.T if self.unembed is None else self.unembed
        logits = matmul(x, unembed.to(x.dtype))
        if cfg.vocab_padded != cfg.vocab:
            ids = replicated(
                torch.arange(logits.shape[-1], device=logits.device), logits)
            logits = torch.where(
                ids < cfg.vocab, logits,
                torch.tensor(-1e30, dtype=logits.dtype,
                             device=logits.device))
        return logits

    def _all_logits(self, tokens: torch.Tensor, remat: bool = False,
                    layout: Optional[TransformerConfig] = None):
        """tokens [B, S] -> (logits [B, S, V], soft-capped when the config
        says so; the MoE layers' load-balancing losses summed in float32,
        0 for a dense FFN); with ``remat`` each block runs under
        checkpoint, its aux loss a second output. ``layout`` (default the
        config) gives the mesh layout flags."""
        layout = self.cfg if layout is None else layout
        S = tokens.shape[1]
        x = self._embed(tokens)
        if layout.batch_shard_all:
            x = _fsdp_shard(x)
        sin, cos = self._prompt_angles(S)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for block in self.layers:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _block_out, block, x, sin, cos, layout,
                    use_reentrant=False, preserve_rng_state=False)
            else:
                x, aux = _block_out(block, x, sin, cos, layout)
            if aux is not None:
                aux_total = aux_total + aux
        logits = self._logits(rms_norm(x, self.ln_f))
        if self.cfg.logit_softcap > 0:
            c = self.cfg.logit_softcap
            logits = torch.tanh(logits / c) * c
        return logits, aux_total

    # -- entry points ---------------------------------------------------------
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] (soft-capped when the config
        says so)."""
        return self._all_logits(tokens)[0]

    def loss_fn(self, tokens: torch.Tensor, labels: torch.Tensor,
                layout: Optional[TransformerConfig] = None):
        """The training loss with gradients: (ce + 0.01 * aux, ce), ce the
        mean token cross-entropy of the logits against ``labels``
        (``cross_entropy_loss``), aux the MoE layers' load-balancing
        losses summed over layers (0 for a dense FFN), as the reference's.
        Layers run under checkpoint when ``cfg.remat``. ``layout``
        (default the config) gives the mesh layout flags."""
        logits, aux = self._all_logits(tokens, remat=self.cfg.remat,
                                       layout=layout)
        ce = cross_entropy_loss(
            logits, labels.to(self.device, dtype=torch.int32))
        return ce + 0.01 * aux, ce

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, capacity: Optional[int] = None):
        """tokens [B, S] -> (last-position logits [B, V], KVCache). The
        cache holds ``capacity`` >= S positions (default S); those past S
        are zero, as the reference's padded cache is."""
        B, S = tokens.shape
        cfg = self.cfg
        cap = S if capacity is None else capacity
        if cap < S:
            raise ValueError(f"prefill: capacity {cap} < prompt length {S}")
        shape = (cfg.n_layers, B, cfg.n_kv_heads, cap, cfg.hd)
        ks = vs = None
        if not self.meshed:
            ks = torch.zeros(shape, dtype=cfg.compute_dtype,
                             device=self.device)
            vs = torch.zeros_like(ks)
        x = self._embed(tokens)
        sin, cos = self._prompt_angles(S)
        for i, block in enumerate(self.layers):
            x, (k, v), _ = block(x, sin, cos)
            if ks is None:
                ks, vs = (_cache_like(k, shape) for _ in range(2))
            ks[i, :, :, :S] = k
            vs[i, :, :, :S] = v
        logits = self._logits(rms_norm(x, self.ln_f)[:, -1])
        length = replicated(torch.full((B,), S, dtype=torch.int32,
                                       device=self.device), logits)
        return logits, KVCache(ks, vs, length)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: KVCache):
        """token [B, 1] + cache -> (logits [B, V], cache with the token's
        K, V written at ``cache.length`` and the length one longer)."""
        x = self._embed(token)
        sin, cos = self._angles(cache.length[:, None])
        for i, block in enumerate(self.layers):
            x, _, _ = block(x, sin, cos,
                            cache_kv=(cache.k[i], cache.v[i]),
                            pos=cache.length)
        logits = self._logits(rms_norm(x, self.ln_f)[:, -1])
        return logits, KVCache(cache.k, cache.v, cache.length + 1)


def _cache_like(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The zero cache [L, B, hkv, cap, hd] that a prefill fills with
    layers of k [B, hkv, S, hd]: a plain tensor for a plain k, else a
    DTensor with k's layout (its dims one further in)."""
    if not isinstance(k, DTensor):
        return torch.zeros(shape, dtype=k.dtype, device=k.device)
    where = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
             for p in k.placements]
    return dt_zeros(shape, k.dtype, k.device_mesh, where, k.device)

