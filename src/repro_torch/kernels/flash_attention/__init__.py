"""Causal / sliding-window GQA prefill attention: the CUDA kernel
(``kernel.py``, ``csrc/flash_attention.cu``), its plain PyTorch version
(``ref.py``) and the model-layout dispatch by device (``ops.py``)."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
