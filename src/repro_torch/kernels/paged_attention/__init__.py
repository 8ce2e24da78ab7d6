"""One-token decode attention over a ring-buffer KV cache: the CUDA
kernel (``kernel.py``, ``csrc/paged_attention.cu``), its plain PyTorch
version (``ref.py``) and the model-layout dispatch by device
(``ops.py``, RoPE of q included)."""

from repro_torch.kernels.paged_attention.ops import decode_attention  # noqa: F401
