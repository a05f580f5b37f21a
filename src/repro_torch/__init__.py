"""repro_torch — FlowLog (Datalog via incrementality) on PyTorch and CUDA.

The port of the JAX package ``repro`` to one NVIDIA H100: the same front
end (``core``: parser, stratifier, IR, optimizer, analysis; a copy, so
this package never imports JAX) feeding a torch executor (``engine``)
whose hot primitives are hand-written CUDA kernels (``kernels``,
``csrc``). Imports torch, numpy and the standard library only.
"""
