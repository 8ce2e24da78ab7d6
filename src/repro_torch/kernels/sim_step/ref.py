"""The plain version of the ``sim_step`` kernel.

As in ``repro.kernels.sim_step.ref``, the oracle *is* the engine: the
``[G]``-batched eager scan of ``repro_torch.core.simulator``
(``_run_impl`` over ``_make_step`` / ``_service``).  There is one
definition of the step semantics in Python; the CUDA kernel is held
against it.
"""

from __future__ import annotations

from repro_torch.core.simulator import _run_impl as run_sweep_ref  # noqa: F401

__all__ = ["run_sweep_ref"]
