"""Counts where XLA's and PyTorch's float32 transcendentals change the
generator's integer draws, over every uniform the generator can draw.

``workloads.prng.uniform`` takes only 2**24 values (k / 2**24), so both
float draws of the generator can be compared exhaustively on the CPU:
for every profile's Zipf exponent, the hot-set rank
``floor(exp(-log1p(-u) / a1)) - 1`` (counted where it is below the
largest hot set, 16 384, so that it can be used), and for every
profile's mean gap, the gap ``floor(log1p(-u) / log1p(-1 / mean_gap))``.

Run from the repo root (about a minute, ~2 GB):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_torch_float_draws.py
"""

import numpy as np
import jax.numpy as jnp
import torch

from repro.core.traces import WORKLOADS

N = 2**24


def main() -> None:
    u = np.arange(N, dtype=np.uint32).astype(np.float32) \
        * np.float32(5.9604645e-08)
    jl = np.asarray(jnp.log1p(-jnp.asarray(u)))
    tl = torch.log1p(-torch.from_numpy(u)).numpy()
    print(f"log1p(-u): {int((jl != tl).sum())} of {N} values differ")
    one = np.float32(1.0)
    for z in sorted({w.stack_zipf for w in WORKLOADS}):
        a1 = np.maximum(np.float32(z) - one, np.float32(1e-3))
        jz = np.floor(np.asarray(jnp.exp(-jnp.asarray(jl) / a1)))
        tz = np.floor(torch.exp(-torch.from_numpy(tl)
                                / torch.tensor(a1)).numpy())
        n = int(((jz != tz) & (np.minimum(jz, tz) < 16384)).sum())
        print(f"stack_zipf {z}: hot rank differs for {n} of {N} u")
    for g in sorted({w.mean_gap for w in WORKLOADS}):
        p = one / np.maximum(np.float32(g), np.float32(1.001))
        jg = np.floor(jl / np.asarray(jnp.log1p(-jnp.float32(p))))
        tg = np.floor(tl / torch.log1p(-torch.tensor(p)).numpy())
        print(f"mean_gap {g:.2f}: gap differs for {int((jg != tg).sum())} "
              f"of {N} u")


if __name__ == "__main__":
    main()
