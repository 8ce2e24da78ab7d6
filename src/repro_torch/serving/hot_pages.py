"""ChargeCache for serving: hot KV-page tracking (port of
``repro.serving.hot_pages``).

The thesis's HCRAC reused as a hot-page table over KV-cache pages: a
page that was just streamed through the row buffers is cheap to re-open
within the caching window, so the batch scheduler prefers requests whose
pages are hot.  The table is ``repro_torch.core.hcrac`` at one point
(``G = 1``) on the tracker's device; batched probes go through the probe
kernel's dispatch (``repro_torch.kernels.hcrac.ops``), which launches
the CUDA kernel for a table on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hcrac as hcl
from repro_torch.core.simulator import _resolve_device
from repro_torch.core.timing import ms_to_cycles

__all__ = ["HotPageConfig", "HotPageTracker"]


@dataclasses.dataclass
class HotPageConfig:
    n_entries: int = 1024
    n_ways: int = 2
    caching_ms: float = 1.0
    page_tokens: int = 2048          # tokens of KV per HBM page granule
    #: page id -> DRAM (bank, row) mapping for the closed-loop simulator
    n_banks: int = 16
    n_rows: int = 65536
    #: idealised per-entry expiry timer instead of the IIC/EC sweep
    #: (slot-phase independent aliveness, which the host-vs-traced
    #: serving parity relies on)
    exact_expiry: bool = False

    def hcrac(self) -> hcl.HCRACConfig:
        return hcl.HCRACConfig(
            n_entries=self.n_entries, n_ways=self.n_ways,
            caching_cycles=ms_to_cycles(self.caching_ms),
            exact_expiry=self.exact_expiry)


class HotPageTracker:
    """Stateful hot-page table used by the batch scheduler, on ``device``
    (CUDA unless the caller names another).  Page ids are taken modulo
    2**32 as int32 (numpy's wrapping cast), as ``repro``'s tracker takes
    them."""

    def __init__(self, cfg: HotPageConfig, device=None):
        self.cfg = cfg
        self.hc_cfg = cfg.hcrac()
        self.device = _resolve_device(device)
        self.state = hcl.init(self.hc_cfg, 1, self.device)
        self._params = hcl.HCRACParams(*(
            x.to(self.device).reshape(1) for x in hcl.params_of(self.hc_cfg)))

    def _ids(self, page_ids) -> torch.Tensor:
        return torch.from_numpy(
            np.asarray(page_ids).astype(np.int32)).to(self.device)

    def probe(self, page_ids: np.ndarray, now_cycles: int) -> np.ndarray:
        """Batched read-only lookup (the probe kernel on the card)."""
        if len(page_ids) == 0:
            return np.zeros(0, bool)
        from repro_torch.kernels.hcrac import ops as hc_ops
        gids = self._ids(page_ids)
        t = torch.full(gids.shape, np.int32(now_cycles), dtype=torch.int32,
                       device=self.device)
        table = hcl.HCRACState(*(x[0] for x in self.state))
        return hc_ops.hcrac_lookup(self.hc_cfg, table, gids, t).cpu().numpy()

    def touch(self, page_ids: np.ndarray, now_cycles: int) -> None:
        """Record accesses (insert or refresh entries), in page order."""
        t = torch.full((1,), np.int32(now_cycles), dtype=torch.int32,
                       device=self.device)
        for g in self._ids(page_ids).split(1):
            hcl.insert(self.hc_cfg, self.state, g, t, True, self._params)

    def page_to_dram(self, page_ids: np.ndarray):
        """Hash page ids onto (bank, row) for the closed-loop DRAM sim
        (splitmix64 finalizer, full avalanche: a multiplicative hash
        would keep the page-id stride and alias every row of a bank into
        one HCRAC set)."""
        h = np.asarray(page_ids, np.uint64)
        h = (h + np.uint64(0x9E3779B97F4A7C15))
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
        bank = (h % np.uint64(self.cfg.n_banks)).astype(np.int32)
        row = ((h >> np.uint64(8)) % np.uint64(self.cfg.n_rows)).astype(
            np.int32)
        return bank, row
