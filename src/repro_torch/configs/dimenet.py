"""dimenet [arXiv:2003.03123]: 6 blocks, hidden 128, 8 bilinear,
7 spherical, 6 radial, cutoff 5."""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn import dimenet as M


def make_cfg(d_feat, smoke):
    if smoke:
        return M.DimeNetConfig(n_blocks=2, d_hidden=16, n_bilinear=2,
                               n_spherical=3, n_radial=3)
    return M.DimeNetConfig(n_blocks=6, d_hidden=128, n_bilinear=8,
                           n_spherical=7, n_radial=6, cutoff=5.0)


ARCH = GNNArch("dimenet", "geometric", make_cfg, M.init_params, M.DimeNet)
