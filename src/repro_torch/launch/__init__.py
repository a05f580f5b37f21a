"""Entry points of the port: ``serve`` (batched LM prefill + decode)."""
