"""DeepSeek-Coder 33B — llama-arch [arXiv:2401.14196; hf]."""
from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    num_layers=62, d_model=7168, num_heads=56, kv_heads=8,
    d_ff=19200, vocab_size=32256, max_seq=4096,
    activation="swiglu", remat="full",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=8, kv_heads=2,
                        d_ff=160, vocab_size=256, max_seq=128, remat="none")
