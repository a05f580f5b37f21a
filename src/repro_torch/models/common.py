"""Shared neural building blocks, after ``repro.models.common``.

Explicit dtypes throughout. The mesh names: ``active_abstract_mesh`` (the
mesh that ``launch.mesh.use_mesh`` made active), ``maybe_shard`` (the
reference's sharding constraint, as a DTensor redistribution), ``P`` (a
reference-style partition spec) and ``placements`` (a spec as DTensor
placements).
"""
from __future__ import annotations

import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map


def resolve_device(spec, owner: str) -> torch.device:
    """``spec`` as a device; raises when it names CUDA and there is no
    card, so that an entry point never falls back to the CPU unasked."""
    device = torch.device(spec)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(spec)!r}) but no CUDA device is "
            f"available; pass device='cpu' to run the plain torch path")
    return device


def frozen(t: torch.Tensor) -> torch.nn.Parameter:
    """``t`` as a parameter that takes no gradient (serving)."""
    return torch.nn.Parameter(t, requires_grad=False)


def parameter(t: torch.Tensor, train: bool) -> torch.nn.Parameter:
    """``t`` as a parameter sharing its storage: trainable when ``train``
    (training), else ``frozen``."""
    return torch.nn.Parameter(t, requires_grad=True) if train else frozen(t)


def wire_grads(pairs) -> None:
    """For each (parameter, buffer) pair: zero the buffer and make it the
    parameter's ``.grad``, so that backward accumulates into it in place
    (autograd adds into a defined ``.grad``). A model whose per-layer
    parameters are views of stacked tensors gets its gradients in the
    stacked layout this way, without a copy."""
    for p, buf in pairs:
        buf.zero_()
        if p.grad is not buf:
            p.grad = buf


def normal_init(shape, stddev: float, dtype: torch.dtype,
                generator: torch.Generator, device=None) -> torch.Tensor:
    """Normal(0, stddev) in ``dtype``, scaled in that dtype, drawn from
    ``generator`` (on the generator's device unless ``device`` says)."""
    device = generator.device if device is None else device
    x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=device)
    return x * torch.tensor(stddev, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, cast back to x's dtype, then times (1 + gamma) in
    that dtype (the reference's rounding order)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * (1.0 + gamma.to(dt))


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with float32 statistics (mean, population variance,
    ``rsqrt(var + eps)``), cast back to x's dtype, then times gamma plus
    beta in that dtype (the reference's order)."""
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gamma.to(dt) + beta.to(dt)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                rot_dim: Optional[int] = None):
    """positions int [*S] -> (sin, cos) [*S, rot_dim / 2] float32.
    ``rot_dim`` < head_dim gives partial rotary (ChatGLM's 2d RoPE
    rotates half the head dimensions)."""
    rot = rot_dim or head_dim
    freqs = replicated(torch.exp(
        -math.log(theta)
        * torch.arange(0, rot, 2, dtype=torch.float32,
                       device=positions.device) / rot), positions)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, D]; sin/cos [..., S, rot / 2] broadcast over heads.
    Rotates interleaved pairs (0::2, 1::2) of the first
    ``2 * sin.shape[-1]`` dims and passes the rest."""
    rot = 2 * sin.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    s = sin[..., None, :].to(x.dtype)
    c = cos[..., None, :].to(x.dtype)
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy: logits [*, V] of any float dtype, taken
    in float32 (float32 logsumexp); labels int, clipped into [0, V - 1]
    for the gather; positions labelled ``ignore_id`` are left out of the
    mean (0 when every position is)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    idx = labels.long().clamp(0, lg.shape[-1] - 1)
    ll = settle(torch.gather(lg, -1, idx[..., None]))[..., 0]
    mask = (labels != ignore_id).float()
    return torch.sum((lse - ll) * mask) / torch.clamp_min(mask.sum(), 1.0)


def uniform_init(shape, scale: float, dtype: torch.dtype,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """Uniform(-scale, scale) in ``dtype``, drawn from ``generator`` (on
    the generator's device unless ``device`` says)."""
    device = generator.device if device is None else device
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=device)
    return u * (2 * scale) - scale


# -- the mesh ------------------------------------------------------------------

class P(tuple):
    """A partition spec, the reference's ``PartitionSpec``: one entry a
    tensor dim, None (whole), a mesh axis name, or a tuple of axis names
    (major first). A tuple, so it compares equal to the tuple of a
    reference spec; a leaf of the spec trees (``configs.base``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


_active_mesh = contextvars.ContextVar("active_mesh", default=None)


def set_active_mesh(mesh, token=None):
    """Sets the calling thread's active mesh and returns a token; given a
    token, puts back the mesh that was active before it instead."""
    if token is not None:
        _active_mesh.reset(token)
        return None
    return _active_mesh.set(mesh)


def active_abstract_mesh():
    """The active mesh (a ``DeviceMesh``) of the calling thread, or None
    when no mesh is active (``launch.mesh.use_mesh``)."""
    return _active_mesh.get()


def mesh_axes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh``, or of an object with
    ``axis_names`` and ``axis_sizes`` (``configs.base.AbstractMesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.axis_sizes)))


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (none for None)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec, mesh) -> tuple:
    """A spec (one entry a tensor dim) as DTensor placements on ``mesh``,
    one a mesh dim: ``Shard(d)`` where tensor dim d names the mesh dim's
    axis, else ``Replicate()``. A mesh dim flattened from several axes
    (``launch.mesh.compute_mesh``: "pod_data") takes a run of an entry's
    axes that its name joins with "_"."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes, i = axes_of(entry), 0
        while i < len(axes):
            j = next((j for j in range(len(axes), i, -1)
                      if "_".join(axes[i:j]) in names), None)
            if j is None:
                raise ValueError(f"spec {spec}: no dim of the mesh {names} "
                                 f"takes the axes {axes[i:]}")
            out[names.index("_".join(axes[i:j]))] = Shard(dim)
            i = j
    return tuple(out)


def resolve_spec(shape, entries, sizes: dict) -> P:
    """The reference's ``maybe_shard`` resolution of ``entries`` for a
    tensor of ``shape`` on a mesh of ``sizes`` (axis name -> size):
    "all" takes every axis, "dp" every axis but "model", "model" is
    dropped when the mesh has none, and an entry whose axes' product
    does not divide its dim is dropped (that dim stays whole)."""
    names = tuple(sizes)
    resolved = []
    for i, e in enumerate(entries):
        if e == "all":
            e = names if len(names) > 1 else names[0]
        if e == "dp":
            axes = tuple(a for a in names if a != "model")
            e = axes if len(axes) > 1 else (axes[0] if axes else None)
        if e == "model" and "model" not in names:
            e = None
        if e is not None:
            need = math.prod(sizes[a] for a in axes_of(e))
            if shape[i] % need != 0:
                e = None
        resolved.append(e)
    return P(*resolved)


def maybe_shard(x, *entries):
    """The reference's ``with_sharding_constraint`` that degrades to a
    no-op: with no active mesh, on a plain tensor, or (per dim) where a
    dim does not divide its axes. Otherwise ``x`` redistributed to the
    placements of the resolved spec. Entries: None | an axis name | "dp"
    (every axis but "model") | "all" (every axis)."""
    mesh = active_abstract_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(tuple(x.shape), entries, mesh_axes(mesh))
    return redistributed(x, placements(spec, x.device_mesh))


def redistributed(x: DTensor, where) -> DTensor:
    """``x`` in the placements ``where`` (itself when it has them)."""
    where = tuple(where)
    if tuple(x.placements) == where:
        return x
    return x.redistribute(x.device_mesh, where)


def dt_zeros(shape, dtype: torch.dtype, mesh, where, device) -> DTensor:
    """A DTensor of zeros of global ``shape`` on ``mesh`` with placements
    ``where``, each device's shard on ``device`` (meta included)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    local, _ = compute_local_shape_and_global_offset(shape, mesh, where)
    t = torch.zeros(local, dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, mesh, where, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def settle(x):
    """A DTensor with its partial placements reduced to replicated (an
    all-reduce: a row-parallel product's output, or the masked partial of
    a vocab-parallel lookup, which DTensor reduces to nothing else);
    anything else as it is. Its gradient is brought to the same
    placements first, so that the backward of the reduction finds a
    replicated gradient, never a partial one of another kind."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return grad_placed(x.redistribute(x.device_mesh, want))


def grad_placed(x):
    """``x``; a DTensor that needs a gradient gets it in its own
    placements and contiguous, whatever the ops after it give (where the
    backward of the op before it cannot take another: a partial of
    another kind, a split of a dim its view cannot split, or a local
    tensor its view cannot view)."""
    if isinstance(x, DTensor) and x.requires_grad:
        want = tuple(x.placements)
        x.register_hook(lambda g: (g if tuple(g.placements) == want else
                                   g.redistribute(g.device_mesh, want)
                                   ).contiguous())
    return x


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for x [..., k] and w [k, n]. A DTensor x split along a
    middle dim (the sequence of FSDP's DP x SP layout) takes the product
    on each device's rows through ``local_map``, w gathered whole (the
    FSDP unshard; its gradient a partial sum over the devices that split
    x): torch's DTensor before 2.13 cannot fold such a split into the
    product's rows."""
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Shard) and 0 < p.dim < x.ndim - 1
            for p in x.placements) or not all(
            p.is_replicate() or isinstance(p, Shard) and p.dim < x.ndim - 1
            for p in x.placements):
        return x @ w
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim
    w = redistributed(replicated(w, x), whole)
    grad_w = [Partial() if isinstance(p, Shard) else Replicate()
              for p in x.placements]
    return local_map(torch.matmul, out_placements=list(x.placements),
                     in_placements=(tuple(x.placements), tuple(whole)),
                     in_grad_placements=(tuple(x.placements), tuple(grad_w)),
                     device_mesh=mesh)(x, w)


def replicated(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (whole on every device) as a replicated DTensor on the mesh
    of ``like`` when ``like`` is a DTensor; else ``t``."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
