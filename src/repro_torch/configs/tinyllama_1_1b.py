"""TinyLlama-1.1B — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, kv_heads=4,
    d_ff=5632, vocab_size=32000, max_seq=4096,
    activation="swiglu", remat="dots",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, kv_heads=2,
                        d_ff=128, vocab_size=256, max_seq=128, remat="none")
