"""The plain version of the HCRAC probe kernel (port of
``repro.kernels.hcrac.ref``): a vector lookup with no LRU side effect,
the serving scheduler's read-only probe."""

from __future__ import annotations

import torch

from repro_torch.core import hcrac as hcrac_lib
from repro_torch.core.hcrac import NO_TAG, HCRACConfig, HCRACState

__all__ = ["hcrac_lookup_ref"]


def hcrac_lookup_ref(cfg: HCRACConfig, st: HCRACState, gids: torch.Tensor,
                     times: torch.Tensor) -> torch.Tensor:
    """``gids`` / ``times``: int32 ``[Q]``; ``st``: one ``[sets, ways]``
    table -> hits, bool ``[Q]``.  The set is the floor modulo of the gid
    (negative gids included), aliveness as ``hcrac._alive`` with the
    config's own caching duration and sweep period."""
    set_idx = torch.remainder(gids, cfg.n_sets)
    tags = st.tags[set_idx]                                   # [Q, W]
    itime = st.itime[set_idx]
    q = gids.shape[0]
    p = hcrac_lib.HCRACParams(*(x.to(gids.device).expand(q)
                                for x in hcrac_lib.params_of(cfg)))
    alive = hcrac_lib._alive(cfg, set_idx, itime, times, p)
    match = (tags != NO_TAG) & alive & (tags == gids[:, None])
    return match.any(dim=1)
