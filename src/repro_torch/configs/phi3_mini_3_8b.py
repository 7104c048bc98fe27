"""Phi-3-mini 3.8B — RoPE SwiGLU GQA [arXiv:2404.14219; unverified]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, kv_heads=32,
    d_ff=8192, vocab_size=32064, max_seq=4096,
    activation="swiglu", remat="dots",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, kv_heads=4,
                        d_ff=128, vocab_size=256, max_seq=128, remat="none")
