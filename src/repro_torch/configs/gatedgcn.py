"""gatedgcn [arXiv:2003.00982 benchmark config]: 16 layers, hidden 70,
gated aggregation."""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn import gatedgcn as M


def make_cfg(d_feat, smoke):
    if smoke:
        return M.GatedGCNConfig(n_layers=2, d_hidden=16, d_in=d_feat,
                                n_classes=8)
    return M.GatedGCNConfig(n_layers=16, d_hidden=70, d_in=d_feat,
                            n_classes=16)


ARCH = GNNArch("gatedgcn", "feature", make_cfg, M.init_params, M.GatedGCN)
