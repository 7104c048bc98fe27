"""The paper's own artifact: an Amber-style CGRA interconnect config
(32x32 array, five 16-bit tracks, Wilton SBs, MEM columns) — the Canal
side of the framework. Not an LM; selected via the Canal DSE/benchmarks.

Both configs are frozen :class:`InterconnectSpec` design points: hash them
(``FULL.digest()``) to address caches, or compile them through the front
door (``canal_torch.compile(FULL)``).
(Counterpart of repro/configs/cgra_amber.py.)
"""
from repro_torch.core.spec import InterconnectSpec, SwitchBoxType

FULL = InterconnectSpec(
    width=32, height=32, track_width=16, num_tracks=5,
    sb_type=SwitchBoxType.WILTON, reg_density=1.0,
    cb_sides=4, sb_sides=4, mem_columns=(4, 12, 20, 28), io_ring=True,
)


def smoke() -> InterconnectSpec:
    return InterconnectSpec(width=6, height=6, track_width=16, num_tracks=3,
                            sb_type=SwitchBoxType.WILTON, reg_density=1.0,
                            io_ring=True)

