"""Fig 4.2 and Table 6.1: the bitline's ready time against the cell's
idle time, and the lowered timings the charge model derives (port of
``benchmarks/charge_model_bench.py``).  Host-side arithmetic in float32,
no simulation::

    python -m repro_torch.figures.charge_model
"""

from __future__ import annotations

from repro_torch.core import charge_model as cm
from repro_torch.figures import common as C


def run() -> list[str]:
    """The two CSV rows of ``repro``'s driver: Table 6.1's derived
    timings, and Fig 4.2's ready times with their monotonicity."""
    tbl, us = C.timed(cm.derived_table, (1.0, 4.0, 16.0, 64.0))
    derived = ";".join(
        f"{t.duration_ms:g}ms:tRCD={t.tRCD_ns:.1f}ns/tRAS={t.tRAS_ns:.1f}ns"
        for t in tbl)
    ts = [float(cm.t_ready_ns(d)) for d in (0.0, 1.0, 16.0, 64.0)]
    return [C.csv_row("charge_table6.1", us, derived),
            C.csv_row("charge_fig4.2", 0,
                      f"t_ready(full)={ts[0]:.1f}ns;t_ready(64ms)="
                      f"{ts[3]:.1f}ns;monotone="
                      f"{all(a <= b + 1e-6 for a, b in zip(ts, ts[1:]))}")]


if __name__ == "__main__":
    for row in run():
        print(row)
