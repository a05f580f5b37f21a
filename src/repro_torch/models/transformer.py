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
``attn_backend`` is gone (the device picks the kernel), and so are
``scan_layers``, ``seq_parallel`` and ``batch_shard_all`` (TPU compile
and mesh plumbing). ``moe_groups`` stays: the MoE routes each of its
token groups on its own, so the group count decides which tokens exceed
an expert's capacity and drop.

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

from repro_torch.kernels import flash_attention as FA
from repro_torch.models import moe
from repro_torch.models.common import (
    act_fn, apply_rope, cross_entropy_loss, normal_init, parameter,
    resolve_device, rms_norm, rope_angles, wire_grads,
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

    def forward(self, x, sin, cos, cache_kv=None, pos=None):
        """x [B, S, d]. Prefill (no cache): returns (y, (k, v), aux) with
        k, v [B, hkv, S, hd]. Decode (S = 1): writes k, v at ``pos`` [B]
        of the cache (k, v) [B, hkv, Scap, hd] and attends over pos + 1
        positions; returns (y, cache_kv, aux). aux is the MoE's
        load-balancing loss (float32), None for a dense FFN."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        h = rms_norm(x, self.ln1)
        q = (h @ self.wq).reshape(B, S, hq, hd)
        k = (h @ self.wk).reshape(B, S, hkv, hd)
        v = (h @ self.wv).reshape(B, S, hkv, hd)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
            k = rms_norm(k, self.knorm)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        if cache_kv is not None:
            ck, cv = cache_kv
            _scatter_kv(ck, k[:, 0], pos)
            _scatter_kv(cv, v[:, 0], pos)
            attn = FA.flash_decode(q[:, 0].contiguous(), ck, cv, pos + 1)
            new_kv = cache_kv
        else:
            kt = k.transpose(1, 2).contiguous()
            vt = v.transpose(1, 2).contiguous()
            attn = FA.flash_attention(q.transpose(1, 2).contiguous(), kt, vt,
                                      causal=True).transpose(1, 2)
            new_kv = (kt, vt)
        x = x + attn.reshape(B, S, hq * hd) @ self.wo
        h2 = rms_norm(x, self.ln2)
        if cfg.moe:
            y, aux = moe.moe_ffn(self.moe_weights, h2.reshape(B * S, -1),
                                 cfg.moe, groups=cfg.moe_groups)
            return x + y.reshape(B, S, -1), new_kv, aux
        up = h2 @ self.w_in
        if cfg.glu:
            up = act_fn(cfg.act)(h2 @ self.w_gate) * up
        else:
            up = act_fn(cfg.act)(up)
        return x + up @ self.w_out, new_kv, None


def _block_out(block: Block, x, sin, cos):
    """(y, aux) of a block in training: what its checkpoint keeps."""
    y, _, aux = block(x, sin, cos)
    return y, aux


def _scatter_kv(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor) -> None:
    """cache [B, h, S, hd] += new [B, h, hd] at position pos[b] of each
    row, in place. As the reference's one-hot add, a position >= S is
    dropped, without a host read."""
    B, _, S, _ = cache.shape
    rows = torch.arange(B, device=cache.device)
    keep = (pos < S).to(new.dtype)[:, None, None]
    idx = pos.clamp(max=S - 1).long()
    cache[rows, :, idx, :] += new * keep


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
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.to(self.device).long()]
        if self.cfg.name.startswith("gemma"):
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _angles(self, positions: torch.Tensor):
        cfg = self.cfg
        return rope_angles(positions, cfg.hd, cfg.rope_theta, cfg.rot_dim)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        unembed = self.embed.T if self.unembed is None else self.unembed
        logits = x @ unembed.to(x.dtype)
        if cfg.vocab_padded != cfg.vocab:
            ids = torch.arange(logits.shape[-1], device=logits.device)
            logits = torch.where(
                ids < cfg.vocab, logits,
                torch.tensor(-1e30, dtype=logits.dtype,
                             device=logits.device))
        return logits

    def _all_logits(self, tokens: torch.Tensor, remat: bool = False):
        """tokens [B, S] -> (logits [B, S, V], soft-capped when the config
        says so; the MoE layers' load-balancing losses summed in float32,
        0 for a dense FFN); with ``remat`` each block runs under
        checkpoint, its aux loss a second output."""
        S = tokens.shape[1]
        x = self._embed(tokens)
        sin, cos = self._angles(
            torch.arange(S, dtype=torch.int32, device=self.device)[None, :])
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for block in self.layers:
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _block_out, block, x, sin, cos, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, aux = _block_out(block, x, sin, cos)
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

    def loss_fn(self, tokens: torch.Tensor, labels: torch.Tensor):
        """The training loss with gradients: (ce + 0.01 * aux, ce), ce the
        mean token cross-entropy of the logits against ``labels``
        (``cross_entropy_loss``), aux the MoE layers' load-balancing
        losses summed over layers (0 for a dense FFN), as the reference's.
        Layers run under checkpoint when ``cfg.remat``."""
        logits, aux = self._all_logits(tokens, remat=self.cfg.remat)
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
        ks = torch.zeros(shape, dtype=cfg.compute_dtype, device=self.device)
        vs = torch.zeros_like(ks)
        x = self._embed(tokens)
        sin, cos = self._angles(
            torch.arange(S, dtype=torch.int32, device=self.device)[None, :])
        for i, block in enumerate(self.layers):
            x, (k, v), _ = block(x, sin, cos)
            ks[i, :, :, :S] = k
            vs[i, :, :, :S] = v
        logits = self._logits(rms_norm(x, self.ln_f)[:, -1])
        length = torch.full((B,), S, dtype=torch.int32, device=self.device)
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
