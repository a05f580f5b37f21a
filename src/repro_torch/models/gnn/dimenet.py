"""DimeNet [Klicpera et al., arXiv:2003.03123], after
``repro.models.gnn.dimenet``: directional message passing with triplet
(angular) interactions. Config: 6 blocks, hidden 128, 8 bilinear, 7
spherical, 6 radial.

Messages live on directed edges m_ji; an interaction block updates them
from the incoming edge messages m_kj through an angle-dependent bilinear
form:

    m'_ji = W m_ji + sum_{k in N(j) minus i} W_bil[sbf(angle kji)] m_kj

The triplet gather (k->j, j->i) is the Datalog rule
``tri(kj, ji) :- edge(k, j), edge(j, i), k != i``, built once a graph on
the host (``build_triplets``) and consumed as the index pair (t_kj,
t_ji), t_ji sorted. Padded triplets carry t_kj = t_ji = E: ``gather``
clamps t_kj to E - 1, reading a real row, and the segment reduce drops
the id E, so a padded triplet adds nothing (and gets no gradient). Both
aggregations go through the segment-reduce kernel. The config has no
``backend`` or ``unroll``: the device picks the route, and the blocks
run as a Python loop over the stacked leaves.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.common import act_fn, normal_init
from repro_torch.models.gnn.common import (
    GNNModel, aggregate, by_rows, check_sorted, gather,
)
from repro_torch.models.gnn.geometry import angular_basis, bessel_rbf


class DimeNetConfig(NamedTuple):
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 16


class GeoGraph(NamedTuple):
    """Geometric graph with a precomputed triplet relation."""
    positions: torch.Tensor     # [N, 3]
    species: torch.Tensor       # [N] int32
    senders: torch.Tensor       # [E] int32 (edge j -> i: senders = j)
    receivers: torch.Tensor     # [E] int32 (sorted)
    t_kj: torch.Tensor          # [T] int32 edge index of k -> j
    t_ji: torch.Tensor          # [T] int32 edge index of j -> i (sorted)


def init_params(cfg: DimeNetConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree ({"embed_z", "embed_rbf", "w_msg", "head",
    "blocks"}, the per-block leaves stacked [n_blocks, ...]), float32
    normals drawn from ``generator`` (on its device unless ``device``
    says)."""
    d = cfg.d_hidden
    s = d ** -0.5
    L = cfg.n_blocks
    sr = cfg.n_spherical * cfg.n_radial

    def draw(shape, std):
        return normal_init(shape, std, torch.float32, generator, device)

    blocks = {
        "w_self": draw((L, d, d), s),
        "w_kj": draw((L, d, d), s),
        "w_rbf": draw((L, cfg.n_radial, d), cfg.n_radial ** -0.5),
        "w_sbf": draw((L, sr, cfg.n_bilinear), sr ** -0.5),
        "w_bil": draw((L, cfg.n_bilinear, d, d), s / 2),
        "w_out": draw((L, d, d), s),
    }
    return {"embed_z": draw((cfg.n_species, d), 1.0),
            "embed_rbf": draw((cfg.n_radial, d), cfg.n_radial ** -0.5),
            "w_msg": draw((3 * d, d), (3 * d) ** -0.5),
            "head": draw((d, 1), s),
            "blocks": blocks}


def _triplet_basis(vec, rbf, t_kj, t_ji, n_spherical: int):
    """The triplets' angle basis sbf [T, S*R] from the edges' vectors vec
    [E, 3] and radial basis rbf [E, R]: edges (k->j) and (j->i)."""
    v_kj = gather(vec, t_kj)
    v_ji = gather(vec, t_ji)
    cosang = (-(v_kj * v_ji).sum(-1)
              / (torch.linalg.vector_norm(v_kj, dim=-1)
                 * torch.linalg.vector_norm(v_ji, dim=-1) + 1e-9))
    ang = angular_basis(cosang, n_spherical)                  # [T, S]
    return (ang[:, :, None] * gather(rbf, t_kj)[:, None, :]
            ).reshape(ang.shape[0], -1)                       # [T, S*R]


def _triplet_messages(m, sbf, t_kj, w_kj, w_sbf, w_bil):
    """Each triplet's bilinear message [T, d] from the incoming edge's
    message m[t_kj] and the triplet's basis sbf."""
    T = t_kj.shape[0]
    B, d, f = w_bil.shape
    m_kj = gather(m, t_kj) @ w_kj                             # [T, d]
    bil = sbf @ w_sbf                                         # [T, B]
    # einsum("tb,td,bdf->tf") as one product over (b, d)
    return ((bil[:, :, None] * m_kj[:, None, :]).reshape(T, B * d)
            @ w_bil.reshape(B * d, f))


class DimeNet(GNNModel):
    STACKED = "blocks"
    init_params = staticmethod(init_params)

    def forward(self, g: GeoGraph) -> torch.Tensor:
        """g -> per-node energy [N]."""
        cfg, p = self.cfg, self.top
        check_sorted(g.receivers)
        check_sorted(g.t_ji, "t_ji")
        silu = act_fn("silu")
        n_nodes = g.positions.shape[0]
        n_edges = g.senders.shape[0]
        vec = gather(g.positions, g.receivers) - gather(g.positions,
                                                        g.senders)
        dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)        # [E]
        rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff)      # [E, R]

        sbf = by_rows(functools.partial(_triplet_basis,
                                        n_spherical=cfg.n_spherical),
                      g.t_kj, vec, rbf, g.t_kj, g.t_ji, whole=(0, 1))

        z = gather(p["embed_z"], g.species)
        m = silu(torch.cat([gather(z, g.senders), gather(z, g.receivers),
                            rbf @ p["embed_rbf"]], dim=-1)
                 @ p["w_msg"])                                # [E, d]
        for bp in self.stack:
            inter = by_rows(_triplet_messages, g.t_kj, m, sbf, g.t_kj,
                            bp["w_kj"], bp["w_sbf"], bp["w_bil"],
                            whole=(0, 3, 4, 5))
            agg = aggregate(inter, g.t_ji, n_edges, "sum")
            rbf_gate = rbf @ bp["w_rbf"]
            m = m + silu(m @ bp["w_self"] + agg * rbf_gate) @ bp["w_out"]
        node_out = aggregate(m, g.receivers, n_nodes, "sum")
        return (silu(node_out) @ p["head"])[:, 0]             # per node


def build_triplets(senders, receivers, max_triplets: int):
    """Host-side triplet construction (the edge self-join on j):
    tri = {(e_kj, e_ji) : receivers[e_kj] == senders[e_ji], k != i}.
    Returns padded (t_kj, t_ji) int32 arrays sorted by t_ji, padded with
    the edge count E."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    by_recv: dict[int, list[int]] = {}
    for e, r in enumerate(receivers):
        by_recv.setdefault(int(r), []).append(e)
    t_kj, t_ji = [], []
    for e_ji, j in enumerate(senders):
        for e_kj in by_recv.get(int(j), []):
            if senders[e_kj] == receivers[e_ji]:
                continue                                   # k == i
            t_kj.append(e_kj)
            t_ji.append(e_ji)
    order = np.argsort(t_ji, kind="stable")
    t_kj = np.asarray(t_kj, np.int32)[order][:max_triplets]
    t_ji = np.asarray(t_ji, np.int32)[order][:max_triplets]
    pad = max_triplets - len(t_kj)
    E = len(senders)
    return (np.pad(t_kj, (0, pad), constant_values=E),
            np.pad(t_ji, (0, pad), constant_values=E))
