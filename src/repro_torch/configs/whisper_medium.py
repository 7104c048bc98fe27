"""Whisper-medium — enc-dec, conv frontend STUB [arXiv:2212.04356;
unverified]. decode/prefill "seq_len" = decoder self-attention length;
encoder fixed at 1500 frames (see DESIGN.md)."""
from repro_torch.models.config import EncDecConfig, ModelConfig

FULL = ModelConfig(
    name="whisper-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, kv_heads=16,
    d_ff=4096, vocab_size=51865, max_seq=32768,
    encdec=EncDecConfig(encoder_layers=24, encoder_seq=1500, d_frame=128),
    activation="gelu", remat="dots",
)


def smoke() -> ModelConfig:
    return FULL.replace(num_layers=2, d_model=64, num_heads=4, kv_heads=4,
                        d_ff=128, vocab_size=256, max_seq=128, remat="none",
                        encdec=EncDecConfig(encoder_layers=2,
                                            encoder_seq=30, d_frame=16))
