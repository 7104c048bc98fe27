"""Bitstream generation (§3.3, Fig. 2 right).

Translates a routing result (a set of active IR edges plus core configs)
into addressed configuration words, mirroring garnet-style addressing:

    addr = x << 24 | y << 16 | feature_id << 8 | reg_index
    data = mux select value (or packed PE opcode/const)

and back — the decoder is used by the verification round-trip tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .graph import Node
from .lowering import FabricModule


@dataclass(frozen=True)
class ConfigWord:
    addr: int
    data: int

    @property
    def x(self) -> int:
        return (self.addr >> 24) & 0xFF

    @property
    def y(self) -> int:
        return (self.addr >> 16) & 0xFF

    @property
    def feature(self) -> int:
        return (self.addr >> 8) & 0xFF

    @property
    def reg(self) -> int:
        return self.addr & 0xFF


class BitstreamCodec:
    """Bidirectional mapping config-vector <-> addressed words for a lowered
    fabric. Feature ids are assigned per tile deterministically."""

    def __init__(self, fabric: FabricModule):
        self.fabric = fabric
        # deterministic feature numbering per tile
        feats: Dict[Tuple[int, int], List[str]] = {}
        for slot in fabric.config_slots:
            names = feats.setdefault((slot.x, slot.y), [])
            if slot.feature not in names:
                names.append(slot.feature)
        self.feature_ids: Dict[Tuple[int, int, str], int] = {}
        for (x, y), names in feats.items():
            for i, name in enumerate(sorted(names)):
                self.feature_ids[(x, y, name)] = i
        self._addr_to_slot: Dict[int, int] = {}
        for si, slot in enumerate(fabric.config_slots):
            addr = self._addr(slot.x, slot.y,
                              self.feature_ids[(slot.x, slot.y,
                                                slot.feature)],
                              slot.reg_index)
            if addr in self._addr_to_slot:
                raise ValueError(f"bitstream address collision at {addr:#x}")
            self._addr_to_slot[addr] = si

    @staticmethod
    def _addr(x: int, y: int, feature: int, reg: int) -> int:
        if not (0 <= x < 256 and 0 <= y < 256 and 0 <= feature < 256
                and 0 <= reg < 256):
            raise ValueError("address field overflow")
        return (x << 24) | (y << 16) | (feature << 8) | reg

    # ---------------------------------------------------------------- encode
    def encode(self, config: np.ndarray,
               skip_zeros: bool = True) -> List[ConfigWord]:
        words: List[ConfigWord] = []
        for si, slot in enumerate(self.fabric.config_slots):
            val = int(config[si])
            if skip_zeros and val == 0:
                continue
            feature = self.feature_ids[(slot.x, slot.y, slot.feature)]
            words.append(ConfigWord(
                self._addr(slot.x, slot.y, feature, slot.reg_index), val))
        return words

    # ---------------------------------------------------------------- decode
    def decode(self, words: Sequence[ConfigWord]) -> np.ndarray:
        config = np.zeros(self.fabric.num_config, dtype=np.int32)
        for w in words:
            si = self._addr_to_slot.get(w.addr)
            if si is None:
                raise ValueError(f"unknown config address {w.addr:#x}")
            slot = self.fabric.config_slots[si]
            if not (0 <= w.data < max(2, slot.fanin)):
                raise ValueError(
                    f"select {w.data} out of range for fan-in {slot.fanin}")
            config[si] = w.data
        return config

    # ------------------------------------------------------------- route API
    def words_for_route(self, edges: Sequence[Tuple[Node, Node]]
                        ) -> List[ConfigWord]:
        config = self.fabric.route_to_config(edges)
        return self.encode(config)


def serialize(words: Sequence[ConfigWord]) -> np.ndarray:
    """Pack into the on-the-wire (n, 2) uint32 array format."""
    return np.array([[w.addr, w.data] for w in words], dtype=np.uint32) \
        .reshape(-1, 2)


def deserialize(arr: np.ndarray) -> List[ConfigWord]:
    return [ConfigWord(int(a), int(d)) for a, d in arr.reshape(-1, 2)]
