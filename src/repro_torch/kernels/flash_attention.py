"""Attention kernels of the LM serving and training paths.

The wrappers of ``csrc/flash_attention_wgmma.cu``,
``csrc/flash_attention_tf32.cu``, ``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, ``csrc/flash_attention_bwd256.cu`` and
``csrc/flash_attention_bwd_tf32.cu``: ``flash_attention`` replaces
``_attn_kernel`` and ``flash_decode`` replaces ``_decode_kernel`` of
``repro.kernels.flash_attention``. On CPU tensors (and meta tensors, in
a dry run) they run the plain torch versions (``kernels/ref.py``; the
prefill's is ``flash_attention_plain``, blockwise from
``BLOCKWISE_THRESHOLD`` keys on); on CUDA tensors they launch a kernel
or raise.

Training: when an input requires grad (and grad mode is on),
``flash_attention`` runs through a ``torch.autograd.Function`` whose
forward is the prefill kernel of its dtype with its log-sum-exp output
(launch key ``flash_attention_wgmma`` for bfloat16,
``flash_attention_tf32`` for float32) and whose backward is
``flash_attention_bwd``, three hand-written kernels that recompute P
from the saved log-sum-exp, without atomics, so a backward gives the
same bits every time: the pre pass D = rowsum(dO * O), then dK/dV and
dQ. Their launch keys are ``<stem>_dkdv`` and ``<stem>_dq`` with the
stem of ``bwd_stem``: bfloat16 at d in {16, 32, 64, 128}
``flash_attention_bwd`` (wgmma and TMA, pre pass
``flash_attention_bwd_pre``; at d 16 and 32 the d = 64 tiles, TMA
zero-filling the columns past d), bfloat16 at d = 256
``flash_attention_bwd256`` (wgmma and TMA; the same pre pass), float32
at every d ``flash_attention_bwd_tf32`` (3xTF32: on mma.sync at d 16 and
32, on wgmma with one CTA a tile at d 64 and 128, a cluster of two CTAs
that split d at d 256; pre pass ``flash_attention_bwd_tf32_pre``).
On the CPU the same Function runs ``attention_lse_ref`` and
``attention_bwd_ref``. The reference has no
Pallas backward (it trains through its XLA attention); the kernels
replace that route on the card. On the card the backward takes float32
and bfloat16, every d in ``BWD_HEAD_DIMS`` and sq == skv; sq != skv with
grad is refused.

``flash_attention`` picks its kernel by type (``prefill_kernel``); both
run on the tensor cores. bfloat16 goes to wgmma fed by TMA (launch key
``flash_attention_wgmma``), float32 to error-compensated TF32 on
mma.sync (key ``flash_attention_tf32``): each operand is split into a
TF32 hi and lo part and a product is lo.hi + hi.lo + hi.hi with f32
accumulation, about 22 significant bits, which holds the float32
tolerance where one TF32 pass (11 bits) does not.

Contract (the shapes of ``repro.kernels.ops.flash_attention`` and
``flash_decode``):
- ``flash_attention(q, k, v, causal)``: q [b, hq, sq, d], k and v
  [b, hkv, skv, d], hq % hkv == 0, float32 or bfloat16, output in q's
  dtype. The causal mask is aligned to the end; any sq and skv.
- ``flash_decode(q, k, v, kv_len)``: q [b, hq, d], k and v
  [b, hkv, S, d], kv_len an int or [b] int32; positions >= kv_len are
  masked, and kv_len = 0 gives 0.
The kernels take d in {16, 32, 64, 128, 256} (``HEAD_DIMS``; 16 and 32
are the reference's smoke configs and ``launch/train_lm.py``'s SMALL)
and 16-byte aligned inputs (TMA loads, cp.async and bulk copies, 16-byte
vector reads); on a CUDA tensor another d raises. No wrapper pads q, k or
v: at d 16 and 32 the bf16 kernels' TMA boxes are 64 columns wide and
zero-filled past d in shared memory, the float32 kernels read d columns.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, ref

LAUNCHES = {"flash_attention_tf32": 0, "flash_attention_wgmma": 0,
            "flash_decode": 0, "flash_decode_combine": 0,
            "flash_attention_bwd_pre": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd256_dkdv": 0,
            "flash_attention_bwd256_dq": 0,
            "flash_attention_bwd_tf32_pre": 0,
            "flash_attention_bwd_tf32_dkdv": 0,
            "flash_attention_bwd_tf32_dq": 0}
HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128, 256)
# the products the backward's (dK/dV, dQ) kernels issue, in units of one
# of the five its bound counts, by dtype and head dim, as their sources'
# headers give them: bf16 P and dS enter as hi + lo parts (at d 16 and 32
# at N = 64 over zero columns); float32 is 3xTF32 (counted in the bound)
BWD_PRODUCTS = {"bfloat16": {16: (18, 10), 32: (10, 6), 64: (6, 4),
                             128: (6, 4), 256: (6, 4)},
                "float32": {16: (4, 3), 32: (4, 3), 64: (4, 3), 128: (4, 3),
                            256: (4, 3)}}
SM_COUNT = 132             # the H100's streaming multiprocessors
DECODE_CTAS_PER_SM = 2     # split CTAs resident per SM (96 KB rings)

# from this many keys on, the plain prefill is blockwise (never an
# [sq, skv] score matrix), as the reference's ops.flash_attention switches
# at its XLA_BLOCKWISE_THRESHOLD
BLOCKWISE_THRESHOLD = 4096

flash_decode_plain = ref.decode_attention_ref


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The prefill's plain version: ``blockwise_attention`` at
    ``BLOCKWISE_THRESHOLD`` keys and more, ``attention_ref`` below."""
    if k.shape[2] >= BLOCKWISE_THRESHOLD:
        return ref.blockwise_attention(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


def _check(name: str, tensors, d: int, hq: int, hkv: int) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on "
                         f"{[str(t.device) for t in tensors]}; the kernel "
                         f"takes one CUDA device")
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dtype for t in tensors):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in tensors]}; "
                        f"the kernel takes float32 or bfloat16, all alike")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if hkv <= 0 or hq % hkv:
        raise ValueError(f"{name}: {hq} query heads over {hkv} KV heads")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")


def prefill_kernel(dtype: torch.dtype) -> str:
    """The kernel that serves a prefill of this dtype, both on the tensor
    cores: "wgmma" (bfloat16) or "tf32x3" (float32, error-compensated
    TF32). Both take every d in ``HEAD_DIMS``."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def bwd_stem(dtype: torch.dtype, d: int) -> str:
    """The source (``csrc/<stem>.cu``) and launch keys' stem of the
    backward's dK/dV and dQ kernels: by dtype first, then by head dim.
    float32 at every d: flash_attention_bwd_tf32; bfloat16 at d = 256:
    flash_attention_bwd256; bfloat16 otherwise: flash_attention_bwd."""
    if dtype == torch.float32:
        return "flash_attention_bwd_tf32"
    return "flash_attention_bwd256" if d == 256 else "flash_attention_bwd"


def _scale_log2(d: int) -> float:
    return (1.0 / math.sqrt(d)) * math.log2(math.e)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """[b, hq, sq, d] attention of q over k, v (GQA by head index);
    differentiable (``_Attention``) when an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, False)
    if _build.runs_plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal)
    return _prefill(q, k, v, causal, None)


def attention_plain_autograd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             causal: bool = True) -> torch.Tensor:
    """``flash_attention`` through the plain versions on any device
    (``attention_lse_ref`` forward, ``attention_bwd_ref`` backward): the
    yardstick the checks hold the kernels' training path to; no path of
    the port calls it."""
    return _Attention.apply(q, k, v, causal, True)


class _Attention(torch.autograd.Function):
    """Attention whose forward saves q, k, v, the output and the
    log-sum-exp, and whose backward is ``flash_attention_bwd`` on the
    card (``attention_bwd_ref`` on the CPU or when ``plain``). Its plain
    forward is ``attention_lse_ref`` at every length, not the blockwise
    one: ``attention_bwd_ref`` recomputes the whole probability matrix
    from the saved log-sum-exp, so training's plain route is quadratic in
    memory either way."""

    @staticmethod
    def forward(ctx, q, k, v, causal, plain):
        if plain or _build.runs_plain(q, k, v):
            out, lse = ref.attention_lse_ref(q, k, v, causal=causal)
        else:
            _check_bwd("flash_attention", q, k, v)
            lse = torch.empty(q.shape[:3], dtype=torch.float32,
                              device=q.device)
            out = _prefill(q, k, v, causal, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.plain = causal, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        bwd = ref.attention_bwd_ref if ctx.plain else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, dout, lse, causal=ctx.causal)
        return dq, dk, dv, None, None


def _check_bwd(name: str, q, k, v) -> None:
    """What the backward kernels take, checked before the forward runs."""
    if q.shape[-1] not in BWD_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} with grad; the "
                         f"backward kernels take {BWD_HEAD_DIMS}")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"{name}: sq {q.shape[2]} != skv {k.shape[2]} "
                         f"with grad; the backward kernels take sq == skv")


def _prefill(q, k, v, causal, lse):
    """The tensor-core prefill kernel for q's dtype; ``lse``, when given,
    also receives each row's log-sum-exp (the kernel's ``_lse`` entry)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    _check("flash_attention", (q, k, v), d, hq, hkv)
    if k.shape != (b, hkv, skv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the tensor-core kernels' TMA "
                         "and cp.async loads need 16-byte aligned inputs")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    name = ("flash_attention_wgmma" if prefill_kernel(q.dtype) == "wgmma"
            else "flash_attention_tf32")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        tail = (b, hq, hkv, sq, skv, d, int(causal), _scale_log2(d), stream)
        if lse is None:
            rc = _prefill_fn(name)(*args, *tail)
        else:
            rc = _lse_fn(name)(*args, lse.data_ptr(), *tail)
        _build.check(rc, name)
        _build.count_launch(LAUNCHES, name)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True):
    """(dq, dk, dv) of ``flash_attention`` at output ``o`` (as the
    forward gave it) with output gradient ``do`` and the forward's
    log-sum-exp ``lse`` [b, hq, s] float32: three launches
    (``bwd_launches``). q, k, v, o, do all float32 or all bfloat16; d in
    ``BWD_HEAD_DIMS``; sq == skv; dk and dv summed over each KV head's
    group. On CPU tensors, ``attention_bwd_ref``."""
    if _build.runs_plain(q, k, v, o, do, lse):
        return ref.attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    _check("flash_attention_bwd", (q, k, v, o, do), d, hq, hkv)
    _check_bwd("flash_attention_bwd", q, k, v)
    if (k.shape != (b, hkv, s, d) or v.shape != k.shape
            or o.shape != q.shape or do.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (b, hq, s)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be [b, hq, s] "
                         f"float32 on {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError("flash_attention_bwd: the kernels' 16-byte "
                         "copies need 16-byte aligned inputs")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not q.numel():
        return dq, dk.zero_(), dv.zero_()
    for launch in bwd_launches(q, k, v, o, do, lse, causal, dq, dk,
                               dv).values():
        launch()
    return dq, dk, dv


def bwd_launches(q, k, v, o, do, lse, causal, dq, dk, dv) -> dict:
    """The backward's three launches on checked CUDA inputs, in order,
    as {name: function that launches it}: the pre pass (D = rowsum(dO
    O) into a scratch buffer: ``flash_attention_bwd_tf32_pre`` of
    ``csrc/flash_attention_bwd_tf32.cu`` for float32,
    ``flash_attention_bwd_pre`` of ``csrc/flash_attention_bwd.cu`` for
    bfloat16), then dK/dV and dQ into the given outputs, the kernels of
    ``csrc/<bwd_stem>.cu`` (``<stem>_dkdv``, ``<stem>_dq``).
    ``flash_attention_bwd`` runs them; ``chip_smoke.py`` also times the
    last two apart."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    stem = bwd_stem(q.dtype, d)
    main = _bwd_lib(stem)
    # the bf16 d = 256 source has no pre pass of its own
    pre_stem = ("flash_attention_bwd" if stem == "flash_attention_bwd256"
                else stem)
    lib = _bwd_lib(pre_stem)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    tail = (b, hq, hkv, s, d, int(causal), _scale_log2(d), 1.0 / math.sqrt(d))

    def launch(of, name, *args):
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            _build.check(getattr(of, name)(*args, stream), name)
            _build.count_launch(LAUNCHES, name)

    return {
        f"{pre_stem}_pre": lambda: launch(
            lib, f"{pre_stem}_pre", o.data_ptr(), do.data_ptr(),
            delta.data_ptr(), b * hq * s, d),
        f"{stem}_dkdv": lambda: launch(
            main, f"{stem}_dkdv", *common, dk.data_ptr(), dv.data_ptr(),
            *tail),
        f"{stem}_dq": lambda: launch(
            main, f"{stem}_dq", *common, dq.data_ptr(), *tail),
    }


def decode_splits(batch: int, hkv: int, S: int) -> tuple[int, int]:
    """(n_splits, split_len): cut the cache length so that the split
    kernel's grid fills the H100's 132 SMs at two CTAs each in about one
    wave, with 256 to 2048 positions per split (a split streams at least
    four 64-row stages of a bf16 d = 128 cache; longer caches take more
    waves, which evens out ragged lengths); split_len is a multiple of
    32."""
    want = max(1, SM_COUNT * DECODE_CTAS_PER_SM // max(batch * hkv, 1))
    n = max(1, min(want, -(-S // 256)), -(-S // 2048))
    split_len = -(-S // n)
    split_len = -(-split_len // 32) * 32
    return -(-S // split_len) if S else 1, split_len


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len) -> torch.Tensor:
    """[b, hq, d] attention of one query token per sequence over the
    first kv_len positions of a [b, hkv, S, d] cache."""
    if _build.runs_plain(q, k, v):
        return flash_decode_plain(q, k, v, kv_len)
    b, hq, d = q.shape
    hkv, S = k.shape[1], k.shape[2]
    _check("flash_decode", (q, k, v), d, hq, hkv)
    if k.shape != (b, hkv, S, d) or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if isinstance(kv_len, int):
        kv_len = torch.full((b,), kv_len, dtype=torch.int32,
                            device=q.device)
    if (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError(f"flash_decode: kv_len must be [b] int32 on "
                         f"{q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_decode: the kernel's bulk copies and vector "
                         "reads need 16-byte aligned inputs")
    lib = _lib()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    n_splits, split_len = decode_splits(b, hkv, S)
    part_m = torch.empty((b, hq, n_splits), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, hq, n_splits, d), dtype=torch.float32,
                           device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_decode_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), bf16,
            b, hq, hkv, S, d, n_splits, split_len, _scale_log2(d), stream)
        _build.check(rc, "flash_decode_split")
        _build.count_launch(LAUNCHES, "flash_decode")
        rc = lib.flash_decode_combine(
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), bf16, b * hq, d, n_splits, stream)
        _build.check(rc, "flash_decode_combine")
        _build.count_launch(LAUNCHES, "flash_decode_combine")
    return out


def _prefill_fn(name: str):
    """The C entry ``name`` of ``csrc/<name>.cu``: (q, k, v, out, b, hq,
    hkv, sq, skv, d, causal, scale_log2, stream) -> cudaError_t."""
    fn = getattr(_build.load(name), name)
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, F, P]
        fn.restype = I
    return fn


def _lse_fn(name: str):
    """The C entry ``<name>_lse`` of ``csrc/<name>.cu``
    (flash_attention_wgmma or flash_attention_tf32): the prefill entry
    with an lse pointer after ``out``."""
    fn = getattr(_build.load(name), f"{name}_lse")
    if fn.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, F, P]
        fn.restype = I
    return fn


def _bwd_lib(name: str):
    """``csrc/<name>.cu`` (a ``bwd_stem``) with its entries typed:
    ``<name>_dkdv`` and ``<name>_dq`` (q, k, v, dout, lse, delta, the
    outputs, b, hq, hkv, s, d, causal, scale_log2, scale, stream), and
    the pre pass ``<name>_pre`` of flash_attention_bwd and
    flash_attention_bwd_tf32."""
    lib = _build.load(name)
    dkdv = getattr(lib, f"{name}_dkdv")
    if dkdv.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name != "flash_attention_bwd256":
            pre = getattr(lib, f"{name}_pre")
            pre.argtypes = [P, P, P, ctypes.c_int64, I, P]
            pre.restype = I
        for fn, outs in ((dkdv, 2), (getattr(lib, f"{name}_dq"), 1)):
            fn.argtypes = [P] * (6 + outs) + [I] * 6 + [F, F, P]
            fn.restype = I
    return lib


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_decode_split.argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_split.argtypes = [P, P, P, P, P, P, P, I, I, I, I,
                                           I, I, I, I, F, P]
        lib.flash_decode_split.restype = I
        lib.flash_decode_combine.argtypes = [P, P, P, P, I, I, I, I, P]
        lib.flash_decode_combine.restype = I
    return lib
