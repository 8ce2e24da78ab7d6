"""granite-34b-code [arXiv:2405.04324; hf] — llama-arch, MQA (kv=1)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    rope_theta=10000.0, act="silu", norm_kind="rms",
)
