"""nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 rbf,
cutoff 5, E(3)-equivariant tensor products."""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn import nequip as M


def make_cfg(d_feat, smoke):
    if smoke:
        return M.NequIPConfig(n_layers=2, channels=8, l_max=2, n_rbf=4)
    return M.NequIPConfig(n_layers=5, channels=32, l_max=2, n_rbf=8,
                          cutoff=5.0)


ARCH = GNNArch("nequip", "geometric", make_cfg, M.init_params, M.NequIP)
