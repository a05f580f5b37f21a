"""Factorization-machine 2-way interaction.

The wrapper of ``csrc/fm_interaction.cu``, which replaces the TPU kernel
``_fm_kernel`` of ``repro.kernels.fm_interaction``. On CPU tensors it
runs the plain torch version (``kernels/ref.py``); on CUDA tensors it
launches the kernel or raises.

When an input requires grad (and grad mode is on) the call goes through
a ``torch.autograd.Function``: its forward is the same kernel, its
backward the kernel's backward entry (launch key ``fm_interaction_bwd``;
``fm_interaction_bwd_ref`` on the CPU), which gives
dv_fk = g x_f (S_k - x_f v_fk) with S_k = sum_f x_f v_fk, and dx only when
x requires grad. A shared v [f, k] gets its per-row terms summed over
rows by the wrapper (in float32, rounded once to v's dtype). The backward
takes one of two routes, which ``bwd_plan`` picks before the launch from
shapes, strides and alignment: "bulk", a stream of tiles of whole rows
through a ring of shared-memory stages by 1-D bulk copies (per-row v
contiguous across rows), or "staged", the forward's blocks and staging
(every other form).

Contract (``repro.kernels.ops.fm_interaction``, with its ``jax.vmap``
over rows written out as a batch dimension of ``v``):
- ``x`` [b, f] at any element strides (``torch.ones(1, 1).expand(b, f)``
  costs no memory);
- ``v`` [f, k], one factor matrix for every row, or [b, f, k], one per
  row at any batch stride (0 included); each [f, k] matrix contiguous;
- float32 or bfloat16, all alike; the kernel computes in float32 and
  returns [b] in x's dtype;
- any b >= 0, f >= 1, and 1 <= k <= MAX_K.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"fm_interaction": 0, "fm_interaction_bwd": 0}
MAX_K = 32      # the lanes of one row's factor columns lie in one warp

fm_interaction_plain = ref.fm_interaction_ref

# the backward's bulk route (csrc/fm_interaction.cu, fm_bwd_stream_kernel)
TILE_BYTES = 19_200       # a tile's target bytes of v: 12 rows of 39 x 10
MAX_STAGES = 4            # the plan's deepest ring (the kernel takes 8)
CTAS_PER_SM = (2, 1)      # resident CTAs a multiprocessor, tried in order
SMEM_PER_SM = 233_472     # 228 KB a streaming multiprocessor, of which
SMEM_RESERVED = 1024      # 1 KB is reserved for each resident block
SMEM_PER_BLOCK = 232_448  # 227 KB of dynamic shared memory a block
ROUTES = {"staged": 0, "bulk": 1}
STAGED_THREADS = 256      # the staged kernel's block
STAGED_FLOATS = 8192      # and its shared memory (32 KB)


class BwdPlan(NamedTuple):
    """How ``fm_interaction_bwd`` runs: ``route`` "bulk" or "staged";
    ``rows`` a tile (bulk) or a block (staged); ``stages`` of the bulk
    ring (1 for staged); ``ctas`` launched; ``tiles`` of ``rows`` rows;
    ``smem`` bytes of shared memory a CTA; ``span`` bytes of v a full
    tile (bulk; 0 for staged); ``ctas_per_sm`` the plan counts on."""
    route: str
    rows: int
    stages: int
    ctas: int
    tiles: int
    smem: int
    span: int
    ctas_per_sm: int


def _round_up(n: int, a: int) -> int:
    return -(-n // a) * a


def stream_smem(rows: int, f: int, k: int, itemsize: int,
                stages: int) -> int:
    """Bytes of shared memory of a bulk-route CTA (``stream_layout`` in
    the kernel): the ring's 128-byte aligned stages of ``rows`` rows, S
    [rows, k], g [rows] and x [rows, f] in float32, two mbarriers a
    stage."""
    stage = _round_up(rows * f * k * itemsize, 128)
    return (stages * stage + _round_up(rows * k * 4, 16)
            + _round_up(rows * 4, 16) + _round_up(rows * f * 4, 16)
            + 2 * stages * 8)


def bwd_plan(b: int, f: int, k: int, itemsize: int, per_row: bool,
             sv_b: int, v_ptr: int, dv_ptr: int, sms: int) -> BwdPlan:
    """The backward's route for b rows of v [f, k] (``per_row``: one
    matrix a row, ``sv_b`` elements apart; else one shared matrix) at
    addresses ``v_ptr`` and ``dv_ptr`` on a card of ``sms``
    multiprocessors.

    Bulk when v is per row and contiguous across rows (``sv_b == f * k``,
    or b = 1), v and dv are 16-byte aligned, and a ring of at least two
    stages fits: R is the largest multiple of 16 / gcd(row bytes, 16)
    (so that every tile's span is whole 16-byte units, and starts
    16-byte aligned) whose tile holds at most ``TILE_BYTES``, at least
    that multiple; as many stages as fit up to ``MAX_STAGES`` with
    ``CTAS_PER_SM`` CTAs on a multiprocessor (two, else one); the CTAs
    take equal shares of the tiles (ceil(tiles / rounds) CTAs for the
    fewest rounds the resident CTAs allow). Staged otherwise: the
    forward's blocks of 256 / KP rows, the fields in chunks of 32 KB."""
    row_bytes = f * k * itemsize
    L = f * k
    if (per_row and (b == 1 or sv_b == L) and v_ptr % 16 == 0
            and dv_ptr % 16 == 0):
        step = 16 // math.gcd(row_bytes, 16)
        rows = max(step, TILE_BYTES // row_bytes // step * step)
        tiles = -(-b // rows)
        for per_sm in CTAS_PER_SM:
            budget = min(SMEM_PER_SM // per_sm - SMEM_RESERVED,
                         SMEM_PER_BLOCK)
            stages = max((s for s in range(1, MAX_STAGES + 1)
                          if stream_smem(rows, f, k, itemsize, s)
                          <= budget), default=0)
            # the kernel's quotients by one multiply are exact while
            # R * (f k)**2 <= 2**32
            if stages >= 2 and rows * L * L <= 1 << 32:
                rounds = -(-tiles // (per_sm * sms))
                return BwdPlan("bulk", rows, stages, -(-tiles // rounds),
                               tiles, stream_smem(rows, f, k, itemsize,
                                                  stages),
                               rows * row_bytes, per_sm)
    kp = 1 << (k - 1).bit_length()
    rows = STAGED_THREADS // kp
    shared = not per_row or b == 1 or sv_b == 0    # the kernel's sv_b == 0
    per_field = rows + (k if shared else rows * k)
    fc = max(1, min(f, STAGED_FLOATS // per_field))
    blocks = -(-b // rows)
    smem = 4 * (rows * fc + (1 if shared else rows) * fc * k)
    return BwdPlan("staged", rows, 1, blocks, blocks, smem, 0, 0)


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    """Multiprocessors of a CUDA device (cached)."""
    idx = device.index if device.index is not None else (
        torch.cuda.current_device())
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SMS[idx]


def backward_plan(x: torch.Tensor, v: torch.Tensor,
                  dv: torch.Tensor | None = None) -> BwdPlan:
    """The plan ``fm_interaction_bwd`` takes for these CUDA inputs (with
    ``dv`` None: for a new dv from ``torch.empty``, 16-byte aligned)."""
    sv_b = _check(x, v)
    b, f = x.shape
    k = v.shape[-1]
    per_row = v.dim() == 3
    return bwd_plan(b, f, k, v.element_size(), per_row,
                    v.stride(0) if per_row else 0, v.data_ptr(),
                    0 if dv is None else dv.data_ptr(), _sms(v.device))


def _check(x: torch.Tensor, v: torch.Tensor) -> int:
    """Validates the inputs for the kernel; returns v's batch stride."""
    if x.device.type != "cuda" or v.device != x.device:
        raise ValueError(f"fm_interaction: x on {x.device}, v on "
                         f"{v.device}; the kernel takes one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or v.dtype != x.dtype:
        raise TypeError(f"fm_interaction: dtypes {x.dtype}, {v.dtype}; the "
                        f"kernel takes float32 or bfloat16, all alike")
    if x.dim() != 2 or v.dim() not in (2, 3):
        raise ValueError(f"fm_interaction: x {tuple(x.shape)}, v "
                         f"{tuple(v.shape)}; x [b, f] with v [f, k] or "
                         f"[b, f, k]")
    b, f = x.shape
    k = v.shape[-1]
    if tuple(v.shape[:-1]) != ((f,) if v.dim() == 2 else (b, f)):
        raise ValueError(f"fm_interaction: x {tuple(x.shape)} does not "
                         f"match v {tuple(v.shape)}")
    if f < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"fm_interaction: f = {f}, k = {k}; the kernel "
                         f"takes f >= 1 and 1 <= k <= {MAX_K}")
    if (k > 1 and v.stride(-1) != 1) or (f > 1 and v.stride(-2) != k):
        raise ValueError(f"fm_interaction: v strides {v.stride()}; each "
                         f"[f, k] matrix must be contiguous")
    if min(x.stride()) < 0:
        raise ValueError(f"fm_interaction: x strides {x.stride()}")
    return 0 if v.dim() == 2 or b == 1 else v.stride(0)


def fm_interaction(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[b] FM 2-way term of the rows of ``x`` under ``v``;
    differentiable (``_FMInteraction``) when an input requires grad."""
    if torch.is_grad_enabled() and (x.requires_grad or v.requires_grad):
        return _FMInteraction.apply(x, v)
    return _forward(x, v)


class _FMInteraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, v):
        ctx.save_for_backward(x, v)
        return _forward(x, v)

    @staticmethod
    def backward(ctx, g):
        x, v = ctx.saved_tensors
        dx, dv = fm_interaction_bwd(x, v, g.contiguous(),
                                    need_dx=ctx.needs_input_grad[0])
        return dx, dv


def _forward(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    if _build.runs_plain(x, v):
        return fm_interaction_plain(x, v)
    sv_b = _check(x, v)
    b, f = x.shape
    out = torch.empty((b,), dtype=x.dtype, device=x.device)
    if b:
        lib = _fn()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.fm_interaction(
                x.data_ptr(), x.stride(0), x.stride(1), v.data_ptr(), sv_b,
                int(x.dtype == torch.bfloat16), b, f, v.shape[-1],
                out.data_ptr(), stream)
        _build.check(rc, "fm_interaction")
        _build.count_launch(LAUNCHES, "fm_interaction")
    return out


def fm_interaction_bwd(x: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                       need_dx: bool = True):
    """(dx [b, f] or None, dv in v's shape) of ``fm_interaction`` under
    output gradient g [b] (x's dtype, contiguous): one launch of the
    kernel's backward entry; ``fm_interaction_bwd_ref`` on CPU
    tensors."""
    if _build.runs_plain(x, v, g):
        dx, dv = ref.fm_interaction_bwd_ref(x, v, g)
        return (dx if need_dx else None), dv
    if v.dim() == 2 and v.dtype != torch.float32:
        # a shared v sums the rows' terms: take them in float32, round once
        dx, dv = fm_interaction_bwd(x.float(), v.float(), g.float(), need_dx)
        return (dx.to(x.dtype) if need_dx else None), dv.to(v.dtype)
    sv_b = _check(x, v)
    b, f = x.shape
    k = v.shape[-1]
    if (g.shape != (b,) or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"fm_interaction_bwd: g must be [{b}] {x.dtype} "
                         f"on {x.device}")
    dv = torch.empty((b, f, k), dtype=v.dtype, device=v.device)
    dx = torch.empty((b, f), dtype=x.dtype, device=x.device) if (
        need_dx) else None
    if b:
        plan = backward_plan(x, v, dv)
        lib = _fn()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.fm_interaction_bwd(
                x.data_ptr(), x.stride(0), x.stride(1), v.data_ptr(), sv_b,
                g.data_ptr(), int(x.dtype == torch.bfloat16), b, f, k,
                dv.data_ptr(), dx.data_ptr() if need_dx else None,
                ROUTES[plan.route], plan.rows, plan.stages, plan.ctas, stream)
        _build.check(rc, "fm_interaction_bwd")
        _build.count_launch(LAUNCHES, "fm_interaction_bwd")
    if v.dim() == 2:        # one matrix for every row: sum the rows' terms
        dv = dv.sum(dim=0)
    return dx, dv


def _fn():
    lib = _build.load("fm_interaction")
    f = lib.fm_interaction
    if f.argtypes is None:
        P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        f.argtypes = [P, I64, I64, P, I64, I, I64, I64, I, P, P]
        f.restype = I
        lib.fm_interaction_bwd.argtypes = [P, I64, I64, P, I64, P, I, I64,
                                           I64, I, P, P, I, I, I, I, P]
        lib.fm_interaction_bwd.restype = I
    return lib
