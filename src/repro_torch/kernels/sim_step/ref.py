"""The plain version of the ``sim_step`` kernel.

As in ``repro.kernels.sim_step.ref``, the oracle *is* the engine: the
``[G]``-batched eager scan of ``repro_torch.core.simulator``
(``_run_impl`` over ``_make_step`` / ``_service``), and for the
synthesis entry the eager generator in front of it (``_run_synth_impl``:
``workloads.generate``, the folded lookahead, then ``_run_impl`` with
one stream per point), for the window entry the FR-FCFS window engine
(``repro_torch.controller.engine._run_window_impl`` /
``_run_window_synth_impl``), and for the serving entry the serving loop's
engine (``repro_torch.serving.loop.engine._run_serving_impl``: arrivals,
admission, the hot-page table and ``_service`` per page access).  There
is one definition of the semantics in Python; the CUDA kernel's four
entries are held against it.
"""

from __future__ import annotations

from repro_torch.core.simulator import _run_impl as run_sweep_ref  # noqa: F401
from repro_torch.core.simulator import (  # noqa: F401
    _run_synth_impl as run_synth_ref)

from repro_torch.controller.engine import (  # noqa: F401
    _run_window_impl as run_window_ref,
    _run_window_synth_impl as run_window_synth_ref)
from repro_torch.serving.loop.engine import (  # noqa: F401
    _run_serving_impl as run_serve_ref)

__all__ = ["run_sweep_ref", "run_synth_ref", "run_window_ref",
           "run_window_synth_ref", "run_serve_ref"]
