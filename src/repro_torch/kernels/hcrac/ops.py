"""Dispatch of the HCRAC probe kernel.

``hcrac_lookup`` is what ``repro_torch.serving.hot_pages.HotPageTracker
.probe`` calls.  The device of the query tensors decides the path: CPU
tensors run the plain version (``ref.hcrac_lookup_ref``), CUDA tensors
launch the CUDA kernel (``kernel.hcrac_lookup``), and a failed build or
launch raises.  Nothing on the CUDA path calls the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.hcrac import HCRACConfig, HCRACState
from repro_torch.kernels.hcrac import ref

__all__ = ["hcrac_lookup", "launches"]

#: CUDA launches of the probe kernel made through ``hcrac_lookup``
launches = 0


def hcrac_lookup(cfg: HCRACConfig, st: HCRACState, gids: torch.Tensor,
                 times: torch.Tensor) -> torch.Tensor:
    """Probe the ``[sets, ways]`` table ``st`` for int32 ``gids [Q]`` at
    cycles ``times [Q]``; returns hits, bool ``[Q]``.  No query, no
    launch."""
    global launches
    device = gids.device
    if gids.numel() == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    if device.type == "cpu":
        return ref.hcrac_lookup_ref(cfg, st, gids, times)
    if device.type != "cuda":
        raise ValueError(f"hcrac_lookup runs on CPU or CUDA, not {device}")
    from repro_torch.kernels.hcrac import kernel
    hits = kernel.hcrac_lookup(cfg, st.tags, st.itime, gids, times)
    launches += 1
    return hits.bool()
