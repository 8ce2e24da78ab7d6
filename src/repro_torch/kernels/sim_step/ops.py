"""Dispatch of the ``sim_step`` kernel tier.

``run_sweep`` is what ``repro_torch.core.simulator.sweep`` calls.  The
device of the trace tensors decides the path: CPU tensors run the plain
engine (``ref.run_sweep_ref``), CUDA tensors launch the CUDA kernel
(``kernel.sim_step``), and a failed build or launch raises.  Nothing on
the CUDA path calls the plain engine.

The kernel carries the bodies of the five builtin block-bearing policies
(``lldram``, ``chargecache``, ``nuat``, ``rltl``, ``aldram``, in that
fold order).  A registry holding any other block-bearing policy (a
``mechanisms.temporary()`` test policy, say) has no kernel body, so
``run_sweep`` refuses it on either device rather than let the two
devices disagree on what a grid can run.
"""

from __future__ import annotations

from repro_torch.core import mechanisms as registry
from repro_torch.kernels.sim_step import ref

__all__ = ["run_sweep", "launches"]

#: CUDA kernel launches made through ``run_sweep`` in this process
launches = 0

#: the block-bearing policies the kernel carries, in fold order
KERNEL_POLICIES = (("lldram", registry.LLDRAM),
                   ("chargecache", registry.ChargeCache),
                   ("nuat", registry.NUAT),
                   ("rltl", registry.RLTL),
                   ("aldram", registry.ALDRAM))


def check_registry() -> None:
    """Raise ``NotImplementedError`` unless the registry's block-bearing
    policies are exactly the builtin ones the kernel carries."""
    got = tuple((n, type(m)) for n, m in registry.block_bearing())
    if got != KERNEL_POLICIES:
        raise NotImplementedError(
            f"the sim_step kernel carries the builtin policies "
            f"{[n for n, _ in KERNEL_POLICIES]} only; the registry holds "
            f"{[(n, c.__name__) for n, c in got]}")


def run_sweep(shape, stacked, trace: dict, ns, ns_idx, warmup: int,
              n_steps: int, collect_events: bool = True):
    """Run a stacked ``[G]`` grid over one trace; returns ``(stats,
    core_end, events or None)`` as ``ref.run_sweep_ref`` does."""
    global launches
    check_registry()
    device = trace["gap"].device
    if device.type == "cpu":
        return ref.run_sweep_ref(shape, stacked, trace, ns, ns_idx, warmup,
                                 n_steps, collect_events)
    if device.type != "cuda":
        raise ValueError(f"sim_step runs on CPU or CUDA, not {device}")
    from repro_torch.kernels.sim_step import kernel
    out = kernel.sim_step(shape, stacked, trace, ns, ns_idx, warmup,
                          n_steps, collect_events)
    launches += 1
    return out
