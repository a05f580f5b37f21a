"""Synthetic data of the port, after ``repro.data``: the LM token stream
and the recsys id stream (the graph generators are not ported yet)."""
from repro_torch.data.synthetic import lm_batch_stream, recsys_stream

__all__ = ["lm_batch_stream", "recsys_stream"]
