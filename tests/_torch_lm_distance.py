"""Prints the reduced dense models' distance from ``repro`` on the CPU:
``tests/test_torch_lm.py``'s ``served`` run (tinyllama, phi4-mini and
granite, reduced; prefill then three decode steps, ``repro`` through its
Pallas kernels in interpret mode), per config the largest |port - repro|
over the logits and the k / v caches, the mean |d| of each step's logits
and the share of logits that differ.  ``LM_TOL`` in that file is held to
twice the largest distance or more.

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/_torch_lm_distance.py
"""

import numpy as np

import test_torch_lm as t

rows = t.served.__wrapped__()
worst = 0.0
for arch, steps in rows.items():
    big = max(float(np.abs(t._f32(a) - t._f32(b)).max())
              for jl, jc, tl, tc in steps
              for a, b in [(tl, jl)] + [(tc[k], jc[k]) for k in ("k", "v")])
    mean = [float(np.abs(t._f32(tl) - t._f32(jl)).mean())
            for jl, _, tl, _ in steps]
    share = [float((t._f32(tl) != t._f32(jl)).mean())
             for jl, _, tl, _ in steps]
    worst = max(worst, big)
    print(f"{arch}: max |d| {big:.4f}; logits mean |d| by step "
          f"{[round(x, 5) for x in mean]}, share differing "
          f"{[round(x, 3) for x in share]}")
print(f"largest distance {worst:.4f} (LM_TOL {t.LM_TOL})")
