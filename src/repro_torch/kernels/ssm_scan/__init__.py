"""Chunk-local Mamba-1 selective scan: the CUDA kernel (``kernel.py``,
``csrc/ssm_scan.cu``), its plain PyTorch version (``ref.py``) and the
dispatch by device (``ops.py``)."""

from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: F401
