"""Optimizer substrate (port of ``repro.optim``): AdamW, its schedule,
and error-feedback int8 gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, init, update,  # noqa: F401
                                     schedule, global_norm)
from repro_torch.optim import compress  # noqa: F401
