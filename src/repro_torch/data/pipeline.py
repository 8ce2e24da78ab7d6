"""Deterministic, shardable synthetic-token data pipeline (port of
``repro.data.pipeline``, a numpy copy: the same generator calls in the
same order, so a batch here equals ``repro``'s bit for bit under one
numpy).

Stateless RNG keyed by ``(seed, step)``, so restoring ``step``
reproduces the exact stream; a mixture of synthetic "domains" with
Zipf token distributions of different exponents; per-host slicing of
the global batch; a background prefetch thread.  numpy's ``zipf``
stream may differ between numpy versions, so batches made under two
installations need not agree.  Batches are numpy ``int32`` arrays; the
train step moves them to its device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["DataConfig", "global_batch_at", "host_batch_at", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    #: (name, weight, zipf_a) mixture of synthetic domains
    mixture: tuple = (("web", 0.7, 1.2), ("code", 0.2, 1.5),
                      ("math", 0.1, 1.8))
    prefetch: int = 2


def _domain_tokens(rng: np.random.Generator, n: int, vocab: int,
                   zipf_a: float) -> np.ndarray:
    """Zipf-ish token stream (heavy-tailed ranks, like real text)."""
    r = rng.zipf(zipf_a, size=n).astype(np.int64)
    return ((r - 1) % (vocab - 2) + 2).astype(np.int32)


def global_batch_at(cfg: DataConfig, step: int) -> dict:
    """The full global batch for ``step`` (a pure function of it):
    ``tokens`` and ``targets`` [global_batch, seq_len] int32, the targets
    the tokens shifted by one."""
    rng = np.random.default_rng((cfg.seed, step))
    B, S = cfg.global_batch, cfg.seq_len
    weights = np.array([m[1] for m in cfg.mixture])
    weights = weights / weights.sum()
    dom = rng.choice(len(cfg.mixture), size=B, p=weights)
    toks = np.empty((B, S + 1), np.int32)
    for i in range(B):
        toks[i] = _domain_tokens(rng, S + 1, cfg.vocab_size,
                                 cfg.mixture[dom[i]][2])
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def host_batch_at(cfg: DataConfig, step: int, host_id: int = 0,
                  n_hosts: int = 1) -> dict:
    """This host's slice of the global batch (per-host data loading)."""
    gb = global_batch_at(cfg, step)
    per = cfg.global_batch // n_hosts
    sl = slice(host_id * per, (host_id + 1) * per)
    return {k: v[sl] for k, v in gb.items()}


class Prefetcher:
    """Background-thread prefetch of upcoming steps (resumable: pass the
    restored step as ``start_step``).  ``next()`` waits at most
    ``timeout`` seconds for a batch and ``close()`` at most that long for
    the thread, raising ``TimeoutError`` past it: nothing here can hang
    its caller."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_id: int = 0, n_hosts: int = 1,
                 timeout: float = 60.0):
        self.cfg = cfg
        self.step = start_step
        self.timeout = timeout
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._args = (host_id, n_hosts)
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = host_batch_at(self.cfg, step, *self._args)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        try:
            step, batch = self._q.get(timeout=self.timeout)
        except queue.Empty:
            raise TimeoutError(f"no batch within {self.timeout} s") from None
        self.step = step
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=self.timeout)
        if self._thread.is_alive():
            raise TimeoutError("the prefetch thread did not stop within "
                               f"{self.timeout} s")
