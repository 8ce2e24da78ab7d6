"""The data pipeline (port of ``repro.data``); this directory also holds
the golden records (``golden_*.json``) that ``repro_torch.golden``
reads."""
from repro_torch.data.pipeline import (DataConfig, global_batch_at,  # noqa: F401
                                       host_batch_at, Prefetcher)
