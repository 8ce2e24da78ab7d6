"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified] — pixtral-ViT
frontend (stub: 256 precomputed patch embeddings) + mistral-nemo backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128,
    frontend="vision", n_patches=256,
    rope_theta=1e6, act="silu", norm_kind="rms",
)
