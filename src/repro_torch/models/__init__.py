"""Models of the port: the decoder-only transformer LM (``transformer``)
and its building blocks (``common``), and the factorization-machine
recommender (``recsys.fm``)."""
