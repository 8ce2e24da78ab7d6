"""AL-DRAM evaluation config (arXiv:1805.03047 over the Table 5.1
system; port of ``repro.configs.aldram_ddr3``).

Per-bank timing margins at the evaluation's operating-temperature bins
(55/70/85°C); 85°C is the DDR3 guardband, where the ``aldram`` kind
equals ``base`` bit for bit.  The ``temperature`` experiment axis takes
degrees, so ``TEMPERATURES`` feeds it as ``{label: °C}``::

    Experiment(traces=..., axes={
        "temperature": {k: a.temperature_c for k, a in TEMPERATURES.items()},
        "mechanism": ["aldram", "cc_aldram"]})
"""
from repro_torch.core import MechanismConfig, SimConfig
from repro_torch.core.aldram import TEMPERATURE_BINS_C, ALDRAMConfig

SIM_CONFIG = SimConfig(mech=MechanismConfig(kind="aldram"))

#: label -> module profile at each thermal bin (default process bin)
TEMPERATURES = {f"{int(t)}C": ALDRAMConfig(temperature_c=t)
                for t in TEMPERATURE_BINS_C}

MECHANISMS = {
    "aldram": MechanismConfig(kind="aldram"),
    "cc_aldram": MechanismConfig(kind="cc_aldram"),
}
