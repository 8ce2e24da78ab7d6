"""Experiment-facing face of the metric registry (port of
``repro.experiment.metrics``).

The registry itself lives in ``repro_torch.core.metrics``: the
simulator's ``_finalize`` consumes it, and ``repro_torch.experiment``
imports ``repro_torch.core``, never the reverse.  Import from here in
experiment and figure code::

    from repro_torch.experiment import metrics
    @metrics.register_metric("bank_pressure", deps=("acts", "pres"))
    def _bp(acts, pres): return acts / np.maximum(pres, 1)
"""

from repro_torch.core.metrics import (Metric, aggregation_names, deps_for,
                                      finalize_scalars, make_aggregator,
                                      metric_names, register_aggregation,
                                      register_metric, resolve)

__all__ = ["Metric", "register_metric", "metric_names", "resolve",
           "deps_for", "finalize_scalars", "register_aggregation",
           "aggregation_names", "make_aggregator"]
