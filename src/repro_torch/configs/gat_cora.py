"""gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden x 8 heads, attention
aggregation; Cora: 2708 nodes, 1433 features, 7 classes."""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn import gat as M


def make_cfg(d_feat, smoke):
    if smoke:
        return M.GATConfig(n_layers=2, d_hidden=4, n_heads=2,
                           d_in=d_feat, n_classes=7)
    return M.GATConfig(n_layers=2, d_hidden=8, n_heads=8, d_in=d_feat,
                       n_classes=7)


ARCH = GNNArch("gat-cora", "feature", make_cfg, M.init_params, M.GAT,
               n_classes=7)
