"""The batched read-only HCRAC probe as a CUDA kernel (``kernel.py``),
its plain PyTorch version (``ref.py``) and the device dispatch the
serving scheduler's hot-page tracker calls (``ops.py``)."""

from repro_torch.kernels.hcrac.ops import hcrac_lookup  # noqa: F401
