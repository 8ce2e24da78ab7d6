"""The simulator hot loop as a CUDA kernel: one sweep point per thread
block (``kernel.py``), the plain engine as its oracle (``ref.py``), and
the device dispatch the entry points call (``ops.py``)."""

from repro_torch.kernels.sim_step.ops import run_sweep  # noqa: F401
