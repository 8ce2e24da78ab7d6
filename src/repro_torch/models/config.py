"""Model configuration for all assigned architectures (verbatim port of
``repro.models.config``).

One frozen dataclass covers dense / MoE / SSM / hybrid / encoder-decoder
families; per-arch files in ``repro_torch/configs`` instantiate it with published
dimensions.  ``reduced()`` derives the small smoke-test variant.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads

    # attention
    attn_window: int = 0      # >0: sliding-window attention (mixtral)
    # hybrid (recurrentgemma): repeating per-layer pattern
    layer_pattern: tuple = ()  # e.g. ("rec", "rec", "attn")
    local_window: int = 0      # hybrid local-attention window

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ssm (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0      # 0 -> ceil(d_model / 16)

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0          # encoder frames provided by the stub frontend

    # modality stub frontend
    frontend: str = "none"    # none | audio | vision
    n_patches: int = 0        # vision: prefix patch-embedding count

    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_kind: str = "rms"    # rms | layer
    act: str = "silu"         # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert self.family in ("dense", "moe", "ssm", "hybrid", "encdec")
        if self.family != "ssm":
            assert self.n_heads > 0 and self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 so the vocab dim shards on any mesh axis
        (whisper's 51865 is otherwise unshardable).  Padded ids are masked
        out of the loss and decode argmax."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def sub_quadratic(self) -> bool:
        """Whether a 500k-token decode cache is bounded (DESIGN.md §5)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True
        return self.attn_window > 0

    @property
    def has_decode(self) -> bool:
        return True  # no encoder-only archs in the assigned pool

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, H, K = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * K * hd + H * hd * d
        if self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        per_layer = 0
        if self.family == "ssm":
            di, N, dt = self.d_inner, self.ssm_state, self.dt_rank
            per_layer = (d * 2 * di + di * self.ssm_conv + di * (dt + 2 * N)
                         + dt * di + di * N + di + di * d)
        elif self.family == "moe":
            per_layer = attn + self.n_experts * 3 * d * f + d * self.n_experts
        elif self.family == "hybrid":
            pat = self.layer_pattern or ("rec",)
            n_attn = sum(1 for i in range(self.n_layers)
                         if pat[i % len(pat)] == "attn")
            n_rec = self.n_layers - n_attn
            rec = 2 * d * d + d * self.ssm_conv + 2 * d * d // 8 + d * d
            return (n_attn * (attn + mlp) + n_rec * (rec + mlp)
                    + 2 * d * self.n_layers + v * d * (1 if self.tie_embeddings else 2))
        else:
            per_layer = attn + mlp
        n_lyr = self.n_layers
        total = n_lyr * per_layer + v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense_moe_delta = (self.n_experts - self.top_k) * 3 * d * f
        return self.n_params() - self.n_layers * dense_moe_delta

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        pat = self.layer_pattern
        n_layers = max(2, len(pat) if pat else 2)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            attn_window=min(self.attn_window, 32) if self.attn_window else 0,
            local_window=min(self.local_window, 32) if self.local_window else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_dt_rank=8 if self.family == "ssm" else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 16) if self.enc_seq else 0,
            n_patches=min(self.n_patches, 4) if self.n_patches else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len x global_batch, and which step)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
