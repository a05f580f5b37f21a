"""NequIP [Batzner et al., arXiv:2101.03164], after
``repro.models.gnn.nequip``: an E(3)-equivariant interatomic potential.
Config: 5 layers, 32 channels, l_max = 2, 8 radial basis functions,
cutoff 5.

Features are direct sums of O(3) irreps, {l: [N, C, 2l+1]} for l = 0, 1,
2. A convolution sends along each edge the tensor product of the
sender's features with the spherical harmonics of the edge vector,
weighted per path by an MLP of the radial basis:

    msg^{l3}_e = sum_{l1,l2} R^{l1l2l3}(d_e) *
                 CG^{l1l2l3} (h^{l1}_{sender(e)} x Y^{l2}(r_e))
    h'^{l3}_v = SelfInteraction(h^{l3}_v, sum_{e->v} msg^{l3}_e)

The CG tables come from ``geometry.cg`` (float64 numpy, cast to float32
once a model); aggregation is the segment-reduce kernel at 32, 96 and 160
columns (C (2l + 1)). Gate nonlinearity: scalars pass through SiLU, l > 0
channels are gated by learned scalar gates. The config has no
``backend``: the device picks the route. Positions carry no gradient.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.models.common import act_fn, normal_init, redistributed
from repro_torch.models.gnn.common import (
    GNNModel, aggregate, by_rows, check_sorted, gather,
)
from repro_torch.models.gnn.geometry import (
    bessel_rbf, cg, real_sph_harm, tensor_product_paths,
)


class NequIPConfig(NamedTuple):
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16


class GeoGraph(NamedTuple):
    positions: torch.Tensor     # [N, 3]
    species: torch.Tensor       # [N] int32
    senders: torch.Tensor       # [E] int32
    receivers: torch.Tensor     # [E] int32 (sorted)


def init_params(cfg: NequIPConfig, generator: torch.Generator,
                device=None) -> dict:
    """The reference's tree ({"embed_z", "head", "layers"}, the per-layer
    leaves stacked [L, ...]: the radial MLP, the gate and, per l, the
    self-interaction and mix matrices), float32 normals drawn from
    ``generator`` (on its device unless ``device`` says)."""
    P = len(tensor_product_paths(cfg.l_max))
    C, L = cfg.channels, cfg.n_layers

    def draw(shape, std):
        return normal_init(shape, std, torch.float32, generator, device)

    layers = {"radial_w1": draw((L, cfg.n_rbf, 64), cfg.n_rbf ** -0.5),
              "radial_w2": draw((L, 64, P * C), 64 ** -0.5),
              "gate_w": draw((L, C, cfg.l_max * C), C ** -0.5)}
    for li in range(cfg.l_max + 1):
        layers[f"self_{li}"] = draw((L, C, C), C ** -0.5)
        layers[f"mix_{li}"] = draw((L, C, C), C ** -0.5)
    return {"embed_z": draw((cfg.n_species, C), 1.0),
            "head": draw((C, 1), C ** -0.5),
            "layers": layers}


def _channel_mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("nci,cd->ndi", x, w): x [N, C, i] mixed over channels. On
    a mesh, whole on every device through ``local_map`` (DTensor's
    backward of the product would view a split local tensor that cannot
    be viewed)."""
    if not isinstance(x, DTensor):
        return (x.transpose(1, 2) @ w).transpose(1, 2)
    whole = [Replicate()] * x.device_mesh.ndim
    x, w = (redistributed(t, whole) for t in (x, w))
    return local_map(_channel_mix, out_placements=whole,
                     in_placements=(whole, whole),
                     device_mesh=x.device_mesh)(x, w)


def _contract_cg(y: torch.Tensor, cg: torch.Tensor) -> torch.Tensor:
    """einsum("ej,ijk->eik", y, cg): the edges' harmonics y [E, j]
    contracted with a CG table, each device its edges on a mesh
    (``by_rows``: torch's DTensor before 2.13 splits the einsum's
    operands wrongly)."""
    return by_rows(functools.partial(torch.einsum, "ej,ijk->eik"), y, y, cg,
                   whole=(1,))


class NequIP(GNNModel):
    STACKED = "layers"
    init_params = staticmethod(init_params)

    def __init__(self, cfg: NequIPConfig, *args, **kwargs):
        super().__init__(cfg, *args, **kwargs)
        self.paths = tensor_product_paths(cfg.l_max)
        self.cg_tabs = {p: torch.tensor(cg(*p), dtype=torch.float32,
                                        device=self.device)
                        for p in self.paths}

    def forward(self, g: GeoGraph) -> torch.Tensor:
        """g -> per-node energy [N] (invariant under rotation and
        translation of the positions)."""
        cfg, p = self.cfg, self.top
        check_sorted(g.receivers)
        silu = act_fn("silu")
        n_nodes = g.positions.shape[0]
        C = cfg.channels
        vec = gather(g.positions, g.receivers) - gather(g.positions,
                                                        g.senders)
        dist = torch.sqrt((vec * vec).sum(-1) + 1e-12)
        rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)          # [E, R]
        # each device its edges' harmonics on a mesh (``by_rows``: torch's
        # DTensor before 2.13 stacks the components into a wrong layout)
        sh = {l: by_rows(functools.partial(real_sph_harm, l), vec,
                         vec).float()
              for l in range(cfg.l_max + 1)}                   # [E, 2l+1]

        # initial features: scalars from the species embedding; l > 0 zero
        feats = {0: gather(p["embed_z"], g.species)[:, :, None]}
        for l in range(1, cfg.l_max + 1):
            feats[l] = torch.zeros((n_nodes, C, 2 * l + 1),
                                   dtype=torch.float32, device=vec.device)
        for lp in self.stack:
            radial = silu(rbf @ lp["radial_w1"]) @ lp["radial_w2"]
            radial = radial.reshape(-1, len(self.paths), C)    # [E, P, C]
            msgs = {}
            for pi, (l1, l2, l3) in enumerate(self.paths):
                hs = gather(feats[l1], g.senders)              # [E, C, 2l1+1]
                # einsum("eci,ej,ijk->eck", hs, y, cg): y contracted first
                t = _contract_cg(sh[l2], self.cg_tabs[(l1, l2, l3)])
                m = torch.bmm(hs, t) * radial[:, pi, :, None]
                msgs[l3] = m if l3 not in msgs else msgs[l3] + m
            out = {}
            for l in range(cfg.l_max + 1):
                agg = aggregate(msgs[l].reshape(-1, C * (2 * l + 1)),
                                g.receivers, n_nodes, "sum").reshape(
                                    n_nodes, C, -1)
                out[l] = (_channel_mix(feats[l], lp[f"self_{l}"])
                          + _channel_mix(agg, lp[f"mix_{l}"]))
            # gate: scalars -> SiLU; l > 0 gated by learned scalar gates
            gates = torch.sigmoid(out[0][:, :, 0] @ lp["gate_w"]).reshape(
                n_nodes, cfg.l_max, C)
            feats = {0: silu(out[0])}
            for l in range(1, cfg.l_max + 1):
                feats[l] = out[l] * gates[:, l - 1, :, None]
        return (feats[0][:, :, 0] @ p["head"])[:, 0]           # invariant
