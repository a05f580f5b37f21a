"""Synthetic data of the port, after ``repro.data``: only the recsys id
stream so far (the LM and graph generators are not ported yet)."""
from repro_torch.data.synthetic import recsys_stream

__all__ = ["recsys_stream"]
