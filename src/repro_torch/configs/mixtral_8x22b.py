"""mixtral-8x22b [arXiv:2401.04088; hf] — 8 experts top-2, SWA 4096."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    n_experts=8, top_k=2, attn_window=4096,
    rope_theta=1e6, act="silu", norm_kind="rms",
)
