"""Dispatch of the ``sim_step`` kernel tier.

``run_sweep`` is what ``repro_torch.core.simulator.sweep`` calls,
``run_synth`` what ``sweep_synth`` calls, and ``run_serve`` what
``sweep_serving`` calls.  The device of the input tensors decides the
path: CPU tensors run the plain engine (``ref.run_sweep_ref`` /
``run_synth_ref`` / ``run_serve_ref``), CUDA tensors launch the CUDA
kernel's trace, synthesis or serving entry (``kernel.sim_step`` /
``sim_synth`` / ``sim_serve``), and a failed build or launch raises.
Nothing on the CUDA path calls the plain engine.  On the CUDA path the
params may lie on the host (the Experiment runner stages them there):
the kernel packs them there and copies the packed rows without waiting
for the device.  The trace entry follows its trace's device; the other
two take ``device`` (default: where ``warmups`` lies).

The kernel carries the bodies of the five builtin block-bearing policies
(``lldram``, ``chargecache``, ``nuat``, ``rltl``, ``aldram``, in that
fold order).  A registry holding any other block-bearing policy (a
``mechanisms.temporary()`` test policy, say) has no kernel body, so
``run_sweep`` and ``run_synth`` refuse it on either device rather than
let the two devices disagree on what a grid can run.  The serving entry
carries the three builtin serving policies (``fifo``, ``charge_aware``,
``preempting``) and refuses a policy registry holding any other.
"""

from __future__ import annotations

import torch

from repro_torch.core import mechanisms as registry
from repro_torch.kernels.sim_step import ref
from repro_torch.serving.loop import policies as serving_policies

__all__ = ["run_sweep", "run_synth", "run_serve", "launches",
           "synth_launches", "serve_launches"]

#: CUDA launches of the trace entry made through ``run_sweep``
launches = 0
#: CUDA launches of the synthesis entry made through ``run_synth``
synth_launches = 0
#: CUDA launches of the serving entry made through ``run_serve``
serve_launches = 0

#: the block-bearing policies the kernel carries, in fold order
KERNEL_POLICIES = (("lldram", registry.LLDRAM),
                   ("chargecache", registry.ChargeCache),
                   ("nuat", registry.NUAT),
                   ("rltl", registry.RLTL),
                   ("aldram", registry.ALDRAM))


#: the serving policies the kernel carries, in registry order
KERNEL_SERVING_POLICIES = (("fifo", serving_policies.FIFO),
                           ("charge_aware", serving_policies.ChargeAware),
                           ("preempting", serving_policies.Preempting))


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


def run_synth(shape, stacked, wparams, ilparams, warmups, n_cores: int,
              max_len: int, n_steps: int, collect_events: bool = True,
              stream: bool = False, device=None):
    """Generate and scan every point of a stacked ``[G]`` synthetic grid
    on ``device`` (default: where ``warmups`` lies; on a card the params
    may lie on the host); returns ``(stats, core_end, events or None)``
    as ``ref.run_synth_ref`` does, plus the generated streams when
    ``stream`` is set."""
    global synth_launches
    check_registry()
    device = warmups.device if device is None else torch.device(device)
    if device.type == "cpu":
        return ref.run_synth_ref(shape, stacked, wparams, ilparams, warmups,
                                 n_cores, max_len, n_steps, collect_events,
                                 stream)
    if device.type != "cuda":
        raise ValueError(f"sim_step runs on CPU or CUDA, not {device}")
    from repro_torch.kernels.sim_step import kernel
    out = kernel.sim_synth(shape, stacked, wparams, ilparams, warmups,
                           n_cores, max_len, n_steps, collect_events, stream,
                           device)
    synth_launches += 1
    return out


def check_serving_registry() -> None:
    """Raise ``NotImplementedError`` unless the serving policy registry
    holds exactly the builtin policies the kernel carries."""
    got = tuple((n, type(serving_policies.get(n)))
                for n in serving_policies.names())
    if got != KERNEL_SERVING_POLICIES:
        raise NotImplementedError(
            f"the sim_step kernel's serving entry carries the builtin "
            f"policies {[n for n, _ in KERNEL_SERVING_POLICIES]} only; the "
            f"registry holds {[(n, c.__name__) for n, c in got]}")


def run_serve(shape, params, warmups, counts=None, device=None):
    """Run the serving closed loop at every point of a stacked ``[G]``
    grid on ``device`` (default: where ``warmups`` lies; on a card the
    params may lie on the host; ``counts [G, n_steps]`` pins the
    arrivals); returns ``(sim stats, serve stats, final clock, per-step
    arrays or None)`` as ``ref.run_serve_ref`` does."""
    global serve_launches
    check_registry()
    check_serving_registry()
    device = warmups.device if device is None else torch.device(device)
    if device.type == "cpu":
        return ref.run_serve_ref(shape, params, warmups, counts)
    if device.type != "cuda":
        raise ValueError(f"sim_step runs on CPU or CUDA, not {device}")
    from repro_torch.kernels.sim_step import kernel
    out = kernel.sim_serve(shape, params, warmups, counts, device)
    serve_launches += 1
    return out
