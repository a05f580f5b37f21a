"""The FM backward's plan and tile walk (``csrc/fm_interaction.cu``,
``fm_bwd_stream_kernel``) in plain Python on the CPU, and the port's
backward against ``jax.grad`` of the reference's interaction.

The kernel runs only on the card (``tests/test_torch_cuda.py``). Here:
- ``bwd_plan`` on a grid of shapes: the bulk route's tiles are whole
  16-byte units that start 16-byte aligned, its ring fits the shared
  memory it counts on, its CTAs take equal shares of the tiles, and the
  forms the bulk copy cannot take go to the staged route; the FM train
  step's shape takes the bulk route;
- ``stream_walk``, the kernel's walk step for step (CTAs, tiles, the
  bulk-copied prefix and the plain tail, S over the fields in order, dx
  over j in order, dv 16 bytes at a time with the kernel's quotients by
  one multiply), writes every value exactly once and lies within the
  kernel's tolerance of ``fm_interaction_bwd_ref`` and of float64;
- the port's backward (the plain version on CPU tensors) against
  ``jax.grad`` of ``repro.models.recsys.fm._fm_batched`` (fm.py:69) on
  its plain path (backend "xla"; the interpret path has no reverse-mode
  rule: ``pallas_call`` cannot be transposed).

Tolerance (the card's, ``tests/test_torch_cuda.py``): dv within 1e-5 of
the row's |S| + |x v| sums times |g| |x|, dx within 1e-5 of its sum of
|v| (|S| + |x v|) times |g|: float32 sums over the fields in another
order differ by a few units of those magnitudes. bfloat16 also one unit
of the value (2**-8 of it): the kernel rounds once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import fm as JFM
from repro_torch.kernels import fm_interaction as FI
from repro_torch.kernels import ref

SMS = 132       # the H100's multiprocessors
TRAIN = (65536, 39, 10)     # the FM train step's rows, fields, factors


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(b, f, k, itemsize=4, per_row=True, sv_b=None, v_ptr=0, dv_ptr=0,
          sms=SMS):
    sv = f * k if sv_b is None else sv_b
    return FI.bwd_plan(b, f, k, itemsize, per_row, sv, v_ptr, dv_ptr, sms)


# -- the plan -------------------------------------------------------------

PLAN_CASES = {
    "train f32": dict(b=65536, f=39, k=10),
    "train bf16": dict(b=65536, f=39, k=10, itemsize=2),
    "b=1": dict(b=1, f=39, k=10),
    "b=17": dict(b=17, f=39, k=10),
    "b=65537": dict(b=65537, f=39, k=10),
    "row 156 B": dict(b=1000, f=13, k=3),
    "row 78 B bf16": dict(b=1000, f=13, k=3, itemsize=2),
    "row 6 B bf16": dict(b=333, f=1, k=3, itemsize=2),
    "f=400 k=32": dict(b=4096, f=400, k=32),
    "f=400 k=32 bf16": dict(b=4096, f=400, k=32, itemsize=2),
    "f=100 k=16": dict(b=333, f=100, k=16),
    "k=1 f=1": dict(b=5000, f=1, k=1),
    "offset view": dict(b=4096, f=39, k=10, v_ptr=4),
    "offset view bf16": dict(b=4096, f=39, k=10, itemsize=2, v_ptr=2),
    "unaligned dv": dict(b=4096, f=39, k=10, dv_ptr=8),
    "batch stride": dict(b=500, f=39, k=10, sv_b=39 * 10 + 8),
    "expanded v": dict(b=500, f=39, k=10, sv_b=0),
    "shared": dict(b=77, f=13, k=4, per_row=False, sv_b=0),
    "f=2000 k=32": dict(b=64, f=2000, k=32),
    "f=2000 k=32 bf16": dict(b=64, f=2000, k=32, itemsize=2),
}
BULK = {"train f32", "train bf16", "b=1", "b=17", "b=65537", "row 156 B",
        "row 78 B bf16", "row 6 B bf16", "f=400 k=32", "f=400 k=32 bf16",
        "f=100 k=16", "k=1 f=1"}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_bwd_plan_routes_and_holds(case):
    """The route each form takes, and on the bulk route: every tile's span
    whole 16-byte units from a 16-byte aligned start (the tail's bytes past
    its last unit move by plain loads and stores), the ring of 2 to 4
    stages within the shared memory that ``ctas_per_sm`` CTAs share, the
    kernel's quotients exact, the tiles covering the rows once, and each
    CTA within one tile of every other's share."""
    kw = PLAN_CASES[case]
    b, f, k = kw["b"], kw["f"], kw["k"]
    item = kw.get("itemsize", 4)
    plan = _plan(**kw)
    assert plan.route == ("bulk" if case in BULK else "staged"), plan
    assert plan.tiles * plan.rows >= b > (plan.tiles - 1) * plan.rows
    if plan.route == "staged":
        assert plan.stages == 1 and plan.ctas == plan.tiles
        assert plan.smem <= 4 * FI.STAGED_FLOATS
        return
    row_bytes = f * k * item
    assert plan.span == plan.rows * row_bytes and plan.span % 16 == 0
    base = 1 << 20                  # any 16-byte aligned v
    for t in range(plan.tiles):
        assert (base + t * plan.span) % 16 == 0
    assert 2 <= plan.stages <= FI.MAX_STAGES
    assert plan.smem == FI.stream_smem(plan.rows, f, k, item, plan.stages)
    assert plan.ctas_per_sm * (plan.smem + FI.SMEM_RESERVED) <= (
        FI.SMEM_PER_SM)
    assert plan.smem <= FI.SMEM_PER_BLOCK
    assert plan.rows * (f * k) ** 2 <= 1 << 32
    assert plan.ctas <= plan.ctas_per_sm * SMS
    shares = [len(range(c, plan.tiles, plan.ctas)) for c in range(plan.ctas)]
    assert max(shares) - min(shares) <= 1 and min(shares) >= 1
    # one more stage would not fit, or the ring is at its depth
    assert plan.stages == FI.MAX_STAGES or FI.stream_smem(
        plan.rows, f, k, item, plan.stages + 1) > min(
            FI.SMEM_PER_SM // plan.ctas_per_sm - FI.SMEM_RESERVED,
            FI.SMEM_PER_BLOCK)


def test_bwd_plan_train_shape_is_the_bulk_stream():
    """The FM train step's rows [65536, 39, 10] in float32 (x the stride-0
    ones, dx not asked): 12 rows a tile (18,720 B), a ring of 4 stages, two
    CTAs a multiprocessor, 261 CTAs of 20 or 21 of the 5462 tiles."""
    plan = _plan(*TRAIN)
    assert plan == FI.BwdPlan("bulk", 12, 4, 261, 5462, 77728, 18720, 2)


def test_bwd_plan_staged_mirrors_the_forward_blocks():
    """The staged route's numbers are the staged kernel's own: 256 / KP
    rows a block, the fields in chunks that fit 32 KB."""
    plan = _plan(64, 2000, 32)
    assert (plan.rows, plan.ctas) == (8, 8)
    assert plan.smem == 4 * (8 * 31 + 8 * 31 * 32)
    plan = _plan(77, 13, 4, per_row=False, sv_b=0)
    assert (plan.rows, plan.ctas, plan.smem) == (64, 2, 4 * (64 * 13 + 13 * 4))


# -- the tile walk --------------------------------------------------------

def _div(n: int, d: int) -> int:
    """The kernel's ``Div``: floor(n / d) as the high word of n * m, m =
    ceil(2**32 / d); d = 1 passes n through."""
    if d == 1:
        return n
    q = (n * -(-(1 << 32) // d)) >> 32
    assert q == n // d, (n, d)
    return q


def _f32(a):
    return np.float32(a)


def stream_walk(x, v, g, plan, need_dx):
    """(dx or None, dv) of the bulk route, walked as the kernel runs it:
    CTA c takes tiles c, c + ctas, ...; a tile's span [row0 L, row0 L + nr
    L) of v is the bulk-copied prefix (whole 16-byte units) and the tail
    past it; S[r, j] sums x v over the fields in order, dx[r, f] sums v (S
    - x v) over j in order, dv goes 16 bytes at a time through the prefix
    (the quotients of the vector's first value, then a step a value) and
    one value at a time through the tail. Float32 arithmetic, values
    rounded to v's dtype when stored. Asserts that every value of dv (and
    dx) is written exactly once."""
    b, f, k = v.shape
    L = f * k
    item = v.element_size()
    E = 16 // item
    vf = v.float().reshape(-1).numpy()
    xs_all = x.float().numpy()
    gs_all = g.float().numpy()
    xc = x.stride() == (0, 0)

    def rounded(val):
        return float(torch.tensor(val, dtype=torch.float32).to(v.dtype))

    dv = np.full(b * L, np.nan, np.float32)
    dv_writes = np.zeros(b * L, np.int64)
    dx = np.full((b, f), np.nan, np.float32) if need_dx else None
    for c in range(plan.ctas):
        for t in range(c, plan.tiles, plan.ctas):
            row0 = t * plan.rows
            nr = min(plan.rows, b - row0)
            ne = nr * L
            pre = (ne * item) & ~15
            pre //= item
            assert (row0 * L * item) % 16 == 0
            st = vf[row0 * L:row0 * L + ne].copy()     # prefix and tail
            gs = gs_all[row0:row0 + nr]
            xs = xs_all[row0:row0 + nr]

            def xv_of(r, fi):
                return _f32(xs_all[0, 0]) if xc else _f32(xs[r, fi])

            S = np.zeros(nr * k, np.float32)
            for p in range(nr * k):
                r = _div(p, k)
                j = p - r * k
                acc = _f32(0)
                for fi in range(f):
                    acc = _f32(acc + _f32(xv_of(r, fi) * st[r * L + fi * k + j]))
                S[p] = acc
            if need_dx:
                for p in range(nr * f):
                    r = _div(p, f)
                    fi = p - r * f
                    xv = xv_of(r, fi)
                    acc = _f32(0)
                    for j in range(k):
                        vv = _f32(st[r * L + fi * k + j])
                        acc = _f32(acc + _f32(vv * _f32(S[r * k + j]
                                                        - _f32(xv * vv))))
                    assert np.isnan(dx[row0 + r, fi])
                    dx[row0 + r, fi] = rounded(_f32(gs[r]) * acc)
            for q in range(pre // E):
                e0 = q * E
                r = _div(e0, L)
                rem = e0 - r * L
                fi = _div(rem, k)
                j = rem - fi * k
                for u in range(E):
                    xv = xv_of(r, fi)
                    res = _f32(S[r * k + j] - _f32(xv * st[e0 + u]))
                    st[e0 + u] = rounded(_f32(_f32(gs[r]) * xv) * res)
                    j += 1
                    if j == k:
                        j = 0
                        fi += 1
                        if fi == f:
                            fi = 0
                            r += 1
            # the bulk store of the prefix
            dv[row0 * L:row0 * L + pre] = st[:pre]
            dv_writes[row0 * L:row0 * L + pre] += 1
            for tt in range(pre, ne):
                r = _div(tt, L)
                rem = tt - r * L
                fi = _div(rem, k)
                xv = xv_of(r, fi)
                res = _f32(S[r * k + rem - fi * k] - _f32(xv * st[tt]))
                dv[row0 * L + tt] = rounded(_f32(_f32(gs[r]) * xv) * res)
                dv_writes[row0 * L + tt] += 1
    assert (dv_writes == 1).all()
    if need_dx:
        assert not np.isnan(dx).any()
    return (None if dx is None else torch.from_numpy(dx).to(x.dtype),
            torch.from_numpy(dv).reshape(b, f, k).to(v.dtype))


def _bounds(x, v, g):
    """(dv, dx) tolerances of the card's test: 1e-5 of the row's |S| + |x v|
    sums times |g| |x| (per row), and of sum_j |v| (|S| + |x v|) times
    |g| (per value of dx)."""
    x64, v64, g64 = (t.double() for t in (x, v, g))
    xv = x64[:, :, None] * v64
    mag = (xv.sum(1, keepdim=True).abs() + xv.abs())              # [b, f, k]
    dv_tol = 1e-5 * mag.sum(1, keepdim=True) * (
        g64.abs() * x64.abs().amax(1))[:, None, None] + 1e-12
    dx_tol = 1e-5 * (v64.abs() * mag).sum(-1) * g64.abs()[:, None] + 1e-12
    return dv_tol, dx_tol


def _exact(x, v, g):
    """dx, dv in float64."""
    return ref.fm_interaction_bwd_ref(x.double(), v.double(), g.double())


def _inputs(seed, b, f, k, x_form, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(0, 0.5, (b, f, k)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (b,)).astype(np.float32))
    if x_form == "ones":
        x = torch.ones((1, 1)).expand(b, f)
    elif x_form == "const":
        x = torch.full((1, 1), 0.75).expand(b, f)
    else:       # element strides other than row-major
        x = torch.from_numpy(rng.normal(0, 1, (f, b)).astype(np.float32)).t()
    return x.to(dtype), v.to(dtype), g.to(dtype)


WALKS = [
    # (b, f, k, x form, dtype, tile bytes, multiprocessors)
    (17, 39, 10, "ones", torch.float32, FI.TILE_BYTES, SMS),
    (37, 13, 3, "strided", torch.float32, 600, 3),
    (37, 13, 3, "const", torch.float32, 600, 1),
    (29, 7, 5, "strided", torch.bfloat16, 300, 2),
    (23, 39, 10, "ones", torch.bfloat16, 4000, 2),
    (9, 1, 1, "strided", torch.float32, 16, 2),
    (6, 5, 32, "strided", torch.float32, 1, 4),
]


@pytest.mark.parametrize("b,f,k,x_form,dtype,tile_bytes,sms", WALKS)
def test_stream_walk_matches_plain(monkeypatch, b, f, k, x_form, dtype,
                                   tile_bytes, sms):
    """The walk against fm_interaction_bwd_ref and float64 within the
    tolerance; small ``TILE_BYTES`` and multiprocessor counts give several
    CTAs of several tiles each, and tails that end inside a 16-byte unit
    (13 x 3 floats = 156 B a row, 7 x 5 bf16 = 70 B)."""
    monkeypatch.setattr(FI, "TILE_BYTES", tile_bytes)
    x, v, g = _inputs(b * 1000 + f, b, f, k, x_form, dtype)
    plan = _plan(b, f, k, v.element_size(), sms=sms)
    assert plan.route == "bulk"
    need_dx = x_form != "ones"
    dx, dv = stream_walk(x, v, g, plan, need_dx)
    rdx, rdv = ref.fm_interaction_bwd_ref(x, v, g)
    edx, edv = _exact(x, v, g)
    dv_tol, dx_tol = _bounds(x, v, g)
    if dtype == torch.bfloat16:
        dv_tol = dv_tol + edv.abs() * 2 ** -8
        dx_tol = dx_tol + edx.abs() * 2 ** -8
    for want in (rdv, edv):
        assert bool(((dv.double() - want.double()).abs() <= 2 * dv_tol)
                    .all()), float((dv.double() - want.double()).abs().max())
    assert bool(((dv.double() - edv).abs() <= dv_tol).all())
    if need_dx:
        assert bool(((dx.double() - edx).abs() <= dx_tol).all()), float(
            (dx.double() - edx).abs().max())


def test_stream_walk_at_the_train_width_several_ctas(monkeypatch):
    """39 x 10 float32 rows, 12 a tile, on a 1-multiprocessor card: 7
    tiles over 2 CTAs, the last tile 11 rows: S and dv as the train step
    runs them."""
    x, v, g = _inputs(3, 6 * 12 + 11, 39, 10, "ones")
    plan = _plan(83, 39, 10, sms=1)
    assert (plan.rows, plan.tiles, plan.ctas) == (12, 7, 2)
    _, dv = stream_walk(x, v, g, plan, False)
    _, edv = _exact(x, v, g)
    dv_tol, _ = _bounds(x, v, g)
    assert bool(((dv.double() - edv).abs() <= dv_tol).all())


# -- against jax.grad -----------------------------------------------------

def _jax_grads(x, v, g):
    """jax.grad of <g, _fm_batched(v, x)>, the reference model's use of
    the interaction (fm.py:69), on its plain path."""
    b, f, k = v.shape
    cfg = JFM.FMConfig(n_fields=f, embed_dim=k, vocab=16, backend="xla")
    gj = jnp.asarray(g)

    def loss(vv, xx):
        return jnp.vdot(JFM._fm_batched(vv, xx, cfg), gj)

    dv, dx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(x))
    return np.asarray(dx, np.float64), np.asarray(dv, np.float64)


@pytest.mark.parametrize("b,f,k,x_form", [
    (64, 39, 10, "ones"), (50, 13, 3, "strided"), (33, 8, 4, "const"),
    (7, 1, 1, "strided")])
def test_port_backward_matches_jax_grad(b, f, k, x_form):
    """The port's fm_interaction_bwd (the plain version on CPU tensors) and
    the bulk route's walk against jax.grad of the reference's interaction
    on the same seeded numpy inputs, float32, within the tolerance."""
    x, v, g = _inputs(b + f + k, b, f, k, x_form)
    jdx, jdv = _jax_grads(x.contiguous().numpy(), v.numpy(), g.numpy())
    dv_tol, dx_tol = (t.numpy() for t in _bounds(x, v, g))
    dx, dv = FI.fm_interaction_bwd(x, v, g)
    assert dv.shape == v.shape and dx.shape == x.shape
    assert (np.abs(dv.double().numpy() - jdv) <= 2 * dv_tol).all()
    assert (np.abs(dx.double().numpy() - jdx) <= 2 * dx_tol).all()
    wdx, wdv = stream_walk(x, v, g, _plan(b, f, k), need_dx=True)
    assert (np.abs(wdv.double().numpy() - jdv) <= 2 * dv_tol).all()
    assert (np.abs(wdx.double().numpy() - jdx) <= 2 * dx_tol).all()
    edx, edv = _exact(x, v, g)
    assert (np.abs(jdv - edv.numpy()) <= dv_tol).all()
    assert (np.abs(jdx - edx.numpy()) <= dx_tol).all()
