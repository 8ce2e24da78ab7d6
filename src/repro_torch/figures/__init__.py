"""The thesis's figure scripts on the port (port of ``benchmarks/``'
``speedup``, ``capacity``, ``duration``, ``energy`` and ``rltl``).

Each module computes one figure through ``repro_torch.experiment`` and
prints ``repro``'s CSV rows::

    python -m repro_torch.figures.speedup [--quick] [--device cpu]

``common`` holds the thesis's sizes (``THESIS``; ``QUICK`` for
``--quick``), the configurations and the trace caches they share.
"""
