"""The serving closed loop, batched over grid points (port of
``repro.serving.loop``): ``ServingSpec`` (``SimConfig.serving``), the
``@register_policy`` admission/preemption registry, the plain ``[G]``
engine and its entry points (``engine.run_sweep`` /
``simulate_serving``, also ``repro_torch.core.simulator.sweep_serving``
/ ``simulate_serving``), and the host-scheduler parity oracle
(``oracle``)."""

from repro_torch.serving.loop.policies import (Policy, register_policy,
                                               names as policy_names)
from repro_torch.serving.loop.spec import ServingSpec

__all__ = ["ServingSpec", "Policy", "register_policy", "policy_names"]
