"""Kimi K2 — trillion-param MoE, 384 experts top-8, 1 leading dense layer
(paper-table) [arXiv:2501.kimi2; unverified]. d_ff=2048 is the per-expert
width; the leading dense layer and the shared expert use the published
18432/2048 widths. Trained with Adafactor-style factored optimizer states
(AdamW f32 states for 1T params cannot fit 512 x 16 GiB; see DESIGN.md).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, kv_heads=8, head_dim=112,
    d_ff=18432, vocab_size=163840, max_seq=4096,
    moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25, first_k_dense=1, d_ff_shared=2048),
    activation="swiglu", remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=3, d_model=64, num_heads=4, kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, max_seq=128, remat="none",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=1.25, first_k_dense=1,
                      d_ff_shared=32))
