"""RecurrentGemma-2B — RG-LRU + local attention 1:2 [arXiv:2402.19427; hf].
Sub-quadratic: long_500k decode runs (O(1) LRU state + 2048 window)."""
from repro_torch.models.config import HybridConfig, ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, max_seq=8192,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "local_attn"),
                        window=2048, lru_width=2560),
    activation="gelu", remat="dots", sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return FULL.replace(
        num_layers=5, d_model=64, num_heads=4, kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, max_seq=256, remat="none",
        hybrid=HybridConfig(pattern=("rglru", "rglru", "local_attn"),
                            window=32, lru_width=64))
