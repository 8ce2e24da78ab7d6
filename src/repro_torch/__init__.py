"""PyTorch/CUDA port of the ChargeCache reproduction (``repro``).

Grows slice by slice beside the JAX package, which stays the reference;
this package never imports JAX or ``repro``.  So far: the trace-driven
simulator's main path (``repro_torch.core.simulator.simulate`` /
``sweep``), on-device workload synthesis (``simulate_synth`` /
``sweep_synth``, with the generator in ``repro_torch.workloads``) and
the serving closed loop (``simulate_serving`` / ``sweep_serving``, with
the host scheduler and its parity oracle in ``repro_torch.serving``),
run on an NVIDIA GPU by the hand-written ``sim_step`` CUDA kernel's
three entries and the HCRAC probe kernel (``repro_torch.kernels``), or
on the CPU by their plain PyTorch versions.
"""
