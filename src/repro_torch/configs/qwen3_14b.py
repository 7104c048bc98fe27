"""Qwen3-14B — qk-norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, max_seq=4096,
    qk_norm=True, activation="swiglu", remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, kv_heads=2,
                        head_dim=16, d_ff=128, vocab_size=512, max_seq=128,
                        remat="none")
