"""The Canal system in PyTorch: IR, passes, lowering, PnR, bitstream."""
