"""Entry points of the port: ``serve`` (batched LM prefill + decode),
``train`` (the training loop), ``fixpoint`` and ``incremental_serving``
(the engine), ``prefill_attention`` (an A/B timing of the f32 prefill),
and the reference examples' counterparts ``quickstart``,
``program_analysis``, ``train_lm`` and ``gnn_relational``.
"""
