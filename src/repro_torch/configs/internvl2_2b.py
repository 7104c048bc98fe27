"""InternVL2-2B — InternViT + InternLM2 [arXiv:2404.16821; hf].
The ViT frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 256, 1024); a linear projection maps them into the LM."""
from repro_torch.models.config import ModelConfig, VLMConfig

FULL = ModelConfig(
    name="internvl2-2b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, kv_heads=8,
    d_ff=8192, vocab_size=92553, max_seq=4096,
    vlm=VLMConfig(num_patches=256, d_patch=1024),
    activation="swiglu", remat="dots",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, kv_heads=2,
                        d_ff=128, vocab_size=256, max_seq=128, remat="none",
                        vlm=VLMConfig(num_patches=8, d_patch=32))
