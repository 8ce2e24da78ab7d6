"""whisper-small [arXiv:2212.04356; unverified] — enc-dec; conv frontend
is a stub (input_specs provides 1500 precomputed frame embeddings)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    enc_seq=1500, frontend="audio",
    act="gelu", norm_kind="layer", rope_theta=0.0,
)
