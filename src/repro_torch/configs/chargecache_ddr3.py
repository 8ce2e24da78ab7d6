"""The paper's own system config (thesis Table 5.1; port of
``repro.configs.chargecache_ddr3``): DDR3-1600 two-channel DRAM + a
128-entry, 2-way, 1 ms ChargeCache."""
from repro_torch.core import MechanismConfig, SimConfig

SIM_CONFIG = SimConfig()
MECHANISMS = {
    "base": MechanismConfig(kind="base"),
    "chargecache": MechanismConfig(kind="chargecache"),
    "nuat": MechanismConfig(kind="nuat"),
    "cc_nuat": MechanismConfig(kind="cc_nuat"),
    "rltl": MechanismConfig(kind="rltl"),
    "lldram": MechanismConfig(kind="lldram"),
    "aldram": MechanismConfig(kind="aldram"),
    "cc_aldram": MechanismConfig(kind="cc_aldram"),
}
