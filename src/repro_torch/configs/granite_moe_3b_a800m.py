"""IBM Granite 3B-A800M MoE — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from repro_torch.models.config import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, kv_heads=8,
    d_ff=512, vocab_size=49155, max_seq=4096,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512,
                  capacity_factor=1.25, first_k_dense=0),
    activation="swiglu", remat="dots",
)


def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=2, d_model=64, num_heads=4, kv_heads=2, d_ff=64,
        vocab_size=256, max_seq=128, remat="none",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                      capacity_factor=1.25, first_k_dense=0))
