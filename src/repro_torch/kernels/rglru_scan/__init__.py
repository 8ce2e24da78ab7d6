"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + g_t`` as one
fused multiply-add a step, its input ``g_t = x_t * sqrt(max(1 - a_t^2,
1e-9))`` formed in the same pass: the CUDA kernel (``kernel.py``,
``csrc/rglru_scan.cu``), its plain PyTorch version (``ref.py``) and the
dispatch by device (``ops.py``)."""

from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
