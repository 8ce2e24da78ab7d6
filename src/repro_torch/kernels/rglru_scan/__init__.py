"""The RG-LRU gates and linear recurrence ``h_t = a_t * h_{t-1} + g_t``
of recurrentgemma in one pass: ``a_t = exp(nsp * sigmoid(r_pre_t))``,
``g_t = (sigmoid(i_pre_t) * u_t) * sqrt(max(1 - a_t^2, 1e-9))``, each
step one fused multiply-add.  The CUDA kernel (``kernel.py``,
``csrc/rglru_scan.cu``), its plain PyTorch version (``ref.py``) and the
dispatch by device (``ops.py``)."""

from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: F401
