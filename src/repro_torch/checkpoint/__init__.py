"""Checkpointing (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (save, restore, latest_step,  # noqa: F401
                                            AsyncCheckpointer)
