"""Models of the port: the decoder-only transformer LM (``transformer``)
and its building blocks (``common``), the factorization-machine
recommender (``recsys.fm``) and the graph neural networks (``gnn``)."""
