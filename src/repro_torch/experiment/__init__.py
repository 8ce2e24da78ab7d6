"""repro_torch.experiment — the declarative front door over the sweep
engine (port of ``repro.experiment``).

- ``registry``  — the mechanism registry (``@register_mechanism``;
  implementation: ``repro_torch.core.mechanisms``, its public face here).
- ``spec``      — ``Experiment(traces=…, axes=…, metrics=…)``: named
  axes expand into a ``SimConfig`` grid (extensible ``register_axis``).
- ``runner``    — grid dedup, memory-budget chunking and a pipeline of
  launches: ``sweep()`` / ``sweep_traces()`` halves over traces (one
  ``sim_step`` launch a trace batch and chunk), ``sweep_synth()``'s for
  ``Experiment(traces=None)``, the serving loop's for a serving grid.
- ``results``   — ``Results`` with labeled dims/coords: ``.sel()``,
  ``.to_table()``, ``.to_json()`` / ``from_json()``; the streamed layout
  and the ``ResultsWriter`` JSONL sink.
- ``metrics``   — the scalar-metric registry and the streaming
  aggregations behind ``Experiment(reduce=…)``.

``spec``/``runner`` load lazily so that ``import repro_torch.experiment``
stays cheap when only the registry is needed.  An experiment runs on the
card unless it is given ``device="cpu"`` (the plain engine).
"""

from repro_torch.experiment import registry  # noqa: F401
from repro_torch.experiment.registry import (  # noqa: F401
    MechanismPolicy, SelectCtx, default_nuat_bins, register_mechanism)

_LAZY = {
    "Experiment": "spec",
    "register_axis": "spec",
    "AXIS_BUILDERS": "spec",
    "GEOMETRY_PRESETS": "spec",
    "Results": "results",
    "ResultsWriter": "results",
    "run_experiment": "runner",
    "ChunkScheduler": "runner",
    "register_metric": "metrics",
    "metric_names": "metrics",
    "register_aggregation": "metrics",
    "aggregation_names": "metrics",
}

__all__ = ["registry", "MechanismPolicy", "SelectCtx", "default_nuat_bins",
           "register_mechanism", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(
            f"repro_torch.experiment.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
