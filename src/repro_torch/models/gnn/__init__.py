"""Graph neural networks, after ``repro.models.gnn``: the substrate
(``common``), GAT, GatedGCN, DimeNet and NequIP, and the O(3) machinery
of the geometric models (``geometry``)."""
