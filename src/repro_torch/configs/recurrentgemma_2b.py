"""recurrentgemma-2b [arXiv:2402.19427; hf] — RG-LRU + local attn, 1:2.

Griffin pattern: two recurrent blocks, then one local-attention block
(window 2048); MQA (kv=1) with head_dim 256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    layer_pattern=("rec", "rec", "attn"), local_window=2048,
    ssm_conv=4, rope_theta=10000.0, act="gelu", norm_kind="rms",
    tie_embeddings=True,
)
