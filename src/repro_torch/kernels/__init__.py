"""Hand-written CUDA kernels of the port, one package per kernel of
``repro.kernels`` (``kernel.py`` builds and launches, ``ref.py`` is the
plain PyTorch version, ``ops.py`` dispatches by device)."""
