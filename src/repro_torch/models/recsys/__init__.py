"""Recommender models of the port: the factorization machine (``fm``)."""
