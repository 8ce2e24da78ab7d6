"""Public import path for the mechanism registry (port of
``repro.experiment.registry``).

The implementation lives in ``repro_torch.core.mechanisms``: the
simulator imports it at module scope, so it sits in the core layer and
the import graph stays acyclic (``repro_torch.experiment`` imports
``repro_torch.core``, never the other way).  Everything is re-exported
here because registering a mechanism is part of the Experiment API::

    from repro_torch.experiment.registry import register_mechanism

    @register_mechanism("my_policy")
    class MyPolicy(MechanismPolicy):
        ...

A block-bearing policy outside the builtin ones runs on the plain engine
only: the ``sim_step`` kernel carries the builtin policies' bodies and
refuses a registry holding any other (``kernels/sim_step/ops.py``).
"""

from repro_torch.core.mechanisms import *  # noqa: F401,F403
from repro_torch.core.mechanisms import (  # noqa: F401  (non-public helpers)
    block_bearing, build_blocks, canonical_mech, components, get,
    hcrac_gate, names, pad_hints, select_timings, temporary)

#: serving-policy registration is part of the same front door, but the
#: serving loop lives above the core layer: re-exported lazily so that
#: importing the mechanism registry never pulls in the serving engine
_SERVING = ("register_policy", "serving_policy_names")


def __getattr__(name):
    if name in _SERVING:
        from repro_torch.serving.loop import policies as _pol
        return {"register_policy": _pol.register_policy,
                "serving_policy_names": _pol.names}[name]
    raise AttributeError(name)
