"""PyTorch/CUDA port of the ChargeCache reproduction (``repro``).

Grows slice by slice beside the JAX package, which stays the reference;
this package never imports JAX or ``repro``.  So far: the trace-driven
simulator's main path (``repro_torch.core.simulator.simulate`` /
``sweep``), run on an NVIDIA GPU by the hand-written ``sim_step`` CUDA
kernel, or on the CPU by its plain PyTorch version.
"""
