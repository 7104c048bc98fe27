"""Mamba2-1.3B — SSD (state-space duality) [arXiv:2405.21060; unverified].
Attention-free; decode carries an O(1) SSD state."""
from repro_torch.models.config import ModelConfig, SSMConfig

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, kv_heads=0,
    d_ff=0, vocab_size=50280, max_seq=8192,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128,
                  conv_width=4),
    remat="dots", sub_quadratic=True,
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, vocab_size=256,
                        max_seq=256, remat="none",
                        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                                      chunk=32, conv_width=4))
