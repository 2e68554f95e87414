"""Model configuration covering all assigned architectures.

One dataclass describes dense / MoE / hybrid (attention+Mamba) / ssm
(xLSTM) decoder LMs plus the modality-stub frontends ([vlm]/[audio]
backbones receive precomputed patch/frame embeddings via ``input_specs``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # default d_model // n_heads
    arch_type: str = "dense"         # dense | moe | hybrid | ssm
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention
    # hybrid (jamba): period layout, e.g. 8 layers: 1 attn + 7 mamba
    hybrid_period: int = 0
    attn_every: int = 0              # attn at position 0 of each period
    moe_every: int = 0               # moe replaces mlp every k-th position
    # ssm (mamba / xlstm)
    ssm_state: int = 16
    conv_width: int = 4
    xlstm: bool = False              # alternate mLSTM/sLSTM blocks
    # frontend stub: number of prefix embedding positions in input_specs
    frontend: str = "none"           # none | vision | audio
    tied_embeddings: bool = False
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:        # mamba inner width
        return 2 * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (bounded state)?"""
        return self.arch_type in ("hybrid", "ssm") and \
            (self.arch_type != "hybrid" or self.sliding_window > 0)

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=max(2, (self.hybrid_period or 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_head=16,
            d_ff=128,
            vocab=256,
        )
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2), moe_d_ff=64)
        if self.arch_type == "hybrid":
            kw.update(hybrid_period=4, n_layers=4)
        if self.arch_type == "ssm":
            kw.update(n_layers=2, ssm_state=8)
        return self.scaled(**kw)

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + \
            (self.n_heads * dh) * d
        mlp = 3 * d * self.d_ff if self.d_ff else 0
        moe = 3 * d * self.moe_d_ff * self.n_experts + d * self.n_experts \
            if self.n_experts else 0
        mamba = (d * 2 * self.d_inner + self.d_inner * self.conv_width +
                 self.d_inner * (2 * self.ssm_state + 2) +
                 self.d_inner * d)
        per_layer = 0
        if self.arch_type == "dense":
            per_layer = attn + mlp
            total_layers = self.n_layers
            total = per_layer * total_layers
        elif self.arch_type == "moe":
            total = (attn + moe) * self.n_layers
        elif self.arch_type == "hybrid":
            n_periods = self.n_layers // self.hybrid_period
            per_period = 0
            for pos in range(self.hybrid_period):
                per_period += attn if pos == 0 else mamba
                if self.moe_every and pos % self.moe_every == \
                        self.moe_every - 1:
                    per_period += moe
                else:
                    per_period += mlp
            total = per_period * n_periods
        else:  # ssm / xlstm
            per_layer = (4 * d * d) + mlp  # qkv-ish projections + ffn
            total = per_layer * self.n_layers
        total += self.vocab * d * (1 if self.tied_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_experts = 3 * d * self.moe_d_ff * self.n_experts
        active_experts = 3 * d * self.moe_d_ff * max(self.top_k, 1)
        per_layer_saving = dense_experts - active_experts
        layers_with_moe = self.n_layers if self.arch_type == "moe" else \
            (self.n_layers // max(self.moe_every, 1) if self.moe_every else 0)
        return self.param_count() - per_layer_saving * layers_with_moe
