"""O(3) representation machinery for NequIP (l_max = 2) and DimeNet's
angular basis, after ``repro.models.gnn.geometry``.

Real spherical harmonics have closed forms for l <= 2. The equivariant
bilinear contractions (real Clebsch-Gordan tensors) and the real Wigner
rotation matrices are derived numerically with plain numpy, in float64,
by the reference's own steps (copied, so the tables are the same):

* ``wigner(l, R)``: fit ``y_l(R r) = D_l(R) y_l(r)`` over sample points
  (exact: y_l spans a (2l+1)-dim space; lstsq over > 2l+1 points).
* ``cg(l1, l2, l3)``: the space of equivariant bilinear maps
  V_l1 x V_l2 -> V_l3 is at most 1-dimensional; it is the nullspace of
  the intertwining constraint T (D1 x D2) = D3 T stacked over random
  rotations (SVD), scaled to unit norm, its largest-magnitude entry made
  positive. This gives the true real CG, odd-parity paths (1 x 1 -> 1,
  the cross product) included.

``real_sph_harm``, ``bessel_rbf`` and ``angular_basis`` are torch
functions on tensors (``real_sph_harm_np`` is the numpy form the
derivations use).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _sph_components(l: int, x, y, z) -> list:
    """The 2l+1 components (l = 1, 2) of the real spherical harmonic at
    the unit vector (x, y, z), arrays or tensors alike."""
    if l == 1:
        return [y, z, x]
    if l == 2:
        s3 = 3.0 ** 0.5
        return [s3 * x * y,
                s3 * y * z,
                0.5 * (2 * z * z - x * x - y * y),
                s3 * x * z,
                0.5 * s3 * (x * x - y * y)]
    raise NotImplementedError(f"l={l}")


def real_sph_harm_np(l: int, r: np.ndarray) -> np.ndarray:
    """Real spherical harmonics (unnormalized, e3nn-style polynomials) of
    r [..., 3], which need not be unit (it is normalized): [..., 2l+1]."""
    n = np.sqrt((r * r).sum(-1, keepdims=True) + 1e-12)
    x, y, z = (r / n)[..., 0], (r / n)[..., 1], (r / n)[..., 2]
    if l == 0:
        return np.ones(x.shape + (1,), r.dtype)
    return np.stack(_sph_components(l, x, y, z), axis=-1)


def real_sph_harm(l: int, r: torch.Tensor) -> torch.Tensor:
    """``real_sph_harm_np`` on a tensor r [..., 3] -> [..., 2l+1]; a zero
    vector (a padded edge) gives finite values through the eps."""
    n = torch.sqrt((r * r).sum(-1, keepdim=True) + 1e-12)
    x, y, z = (r / n)[..., 0], (r / n)[..., 1], (r / n)[..., 2]
    if l == 0:
        return torch.ones(x.shape + (1,), dtype=r.dtype, device=r.device)
    return torch.stack(_sph_components(l, x, y, z), dim=-1)


def _rand_rotation(rng: np.random.Generator) -> np.ndarray:
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@functools.lru_cache(maxsize=None)
def _sample_points(n: int = 64, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    return p / np.linalg.norm(p, axis=1, keepdims=True)


def wigner(l: int, R: np.ndarray) -> np.ndarray:
    """Real Wigner rotation D_l(R): y_l(R r) = D_l(R) @ y_l(r)."""
    pts = _sample_points()
    A = real_sph_harm_np(l, pts)                          # [n, 2l+1]
    B = real_sph_harm_np(l, pts @ R.T)                    # [n, 2l+1]
    # solve B = A @ D^T  ->  D = (lstsq(A, B)).T
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


@functools.lru_cache(maxsize=None)
def cg(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real Clebsch-Gordan tensor C [2l1+1, 2l2+1, 2l3+1] (unit Frobenius
    norm), or None when no equivariant path exists."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    dim = d1 * d2 * d3
    rng = np.random.default_rng(42)
    rows = []
    for _ in range(6):
        R = _rand_rotation(rng)
        D1, D2, D3 = wigner(l1, R), wigner(l2, R), wigner(l3, R)
        # constraint: D3^T T (D1 x D2) - T = 0 for T flattened [d3, d1*d2]
        M = np.kron(np.kron(D1, D2).T, D3.T) - np.eye(dim)
        rows.append(M)
    M = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(M)
    null = vt[s.size - 1:]
    if s[-1] > 1e-8:
        return None                                        # no path
    c = null[0].reshape(d1, d2, d3)
    c = c / np.linalg.norm(c)
    # sign convention: make the largest-magnitude entry positive
    idx = np.unravel_index(np.argmax(np.abs(c)), c.shape)
    if c[idx] < 0:
        c = -c
    return c


def tensor_product_paths(l_max: int) -> list:
    """All (l1, l2, l3) triples with a CG path, l's <= l_max, in the
    reference's order."""
    return [(l1, l2, l3) for l1 in range(l_max + 1)
            for l2 in range(l_max + 1) for l3 in range(l_max + 1)
            if cg(l1, l2, l3) is not None]


def bessel_rbf(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet/NequIP radial basis: sin(n pi d / c) / d with a smooth
    polynomial cutoff envelope (p = 6). d [...] -> [..., n_rbf]; d is
    clipped to at least 1e-6, so a zero-length (padded) edge is finite."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=d.device)
    x = d[..., None] / cutoff
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n * math.pi * x) / d[..., None]
    p = 6.0
    env = (1 - (p + 1) * (p + 2) / 2 * x ** p
           + p * (p + 2) * x ** (p + 1)
           - p * (p + 1) / 2 * x ** (p + 2))
    env = torch.where(x < 1.0, env, 0.0)
    return basis * env


def angular_basis(cos_angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """DimeNet's angular basis: Chebyshev polynomials of cos(angle) (the
    reference's stand-in for the associated Legendre functions).
    [...] -> [..., n_spherical]."""
    outs = [torch.ones_like(cos_angle), cos_angle]
    for _ in range(2, n_spherical):
        outs.append(2 * cos_angle * outs[-1] - outs[-2])
    return torch.stack(outs[:n_spherical], dim=-1)
