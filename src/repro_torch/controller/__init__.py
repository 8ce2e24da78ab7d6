"""The FR-FCFS controller tier (port of ``repro.controller``).

``SimConfig(controller="frfcfs", window=W)`` gives a point a bounded
request window: the oldest row hit first, else the oldest request, as a
masked argmin each step, with rank-level tRRD/tFAW kept in per-rank ACT
windows.  Every registered mechanism runs on it unchanged: the window
engine hands each request to the in-order tier's ``simulator._service``.

``engine`` — the plain ``[G]``-batched window engine (the plain version
             of the ``sim_window`` entry of the ``sim_step`` kernel);
``oracle`` — the host reference in plain Python integers that both
             engines are held against.
"""
