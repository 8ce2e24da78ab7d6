"""Per-architecture model configs of the assigned pool, and the paper's
own DDR3 system configs (port of ``repro.configs``).

``get(name)`` returns the ModelConfig; ``ALL_ARCHS`` lists the assigned ten,
every one served by ``repro_torch.models.zoo``.
``chargecache_ddr3`` (thesis Table 5.1) and ``aldram_ddr3`` (its AL-DRAM
evaluation) hold ``SIM_CONFIG`` / ``MECHANISMS`` (and ``TEMPERATURES``)
for the simulator; they are not model archs and stay out of
``ALL_ARCHS``.
"""

from importlib import import_module

ALL_ARCHS = [
    "phi4_mini_3p8b",
    "granite_34b",
    "phi3_medium_14b",
    "tinyllama_1p1b",
    "recurrentgemma_2b",
    "whisper_small",
    "falcon_mamba_7b",
    "mixtral_8x22b",
    "phi3p5_moe_42b",
    "pixtral_12b",
]

#: cli alias (--arch ids from the assignment) -> module name
ALIASES = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "granite-34b": "granite_34b",
    "phi3-medium-14b": "phi3_medium_14b",
    "tinyllama-1.1b": "tinyllama_1p1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-small": "whisper_small",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "pixtral-12b": "pixtral_12b",
}


def get(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return import_module(f"repro_torch.configs.{mod}").CONFIG
