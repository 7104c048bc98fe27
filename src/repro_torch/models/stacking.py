"""Layer stacking (counterpart of repro/models/stacking.py).

The reference stacks every layer's parameters along a leading axis and
scans over them (constant compile time in depth). PyTorch runs eagerly,
so the port keeps the layers in an ``nn.ModuleList`` and loops over it
in the same order; ``interop.lm_params_from_numpy`` unstacks the
reference's leading axis into ``<group>.<i>.`` keys.

The reference's ``remat`` policy (activation checkpointing) has no
effect on a forward-only path, so nothing here takes it; the config keeps
the field so that a configuration carries across.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch


def scan_layers(block_fn: Callable, layers: Iterable, x: torch.Tensor,
                carry_extra=None) -> torch.Tensor:
    """x flows through the layers in order; block_fn(layer, x, extra) ->
    x."""
    for layer in layers:
        x = block_fn(layer, x, carry_extra)
    return x


def scan_layers_with_cache(block_fn: Callable, layers: Iterable,
                           x: torch.Tensor, cache: Dict[str, torch.Tensor],
                           carry_extra=None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Serve path: loops over the layers while threading per-layer cache
    slices.

    cache: dict of tensors with a leading layer axis. Layer ``i`` gets
    ``{key: cache[key][i]}`` (views); block_fn(layer, x, layer_cache,
    extra) -> (x, new_layer_cache). A slice the block updated in place
    and returned as is stays; any other returned tensor is copied into
    ``cache[key][i]``. Returns (x, cache), the cache updated in place.
    """
    for i, layer in enumerate(layers):
        layer_cache = {key: t[i] for key, t in cache.items()}
        x, new = block_fn(layer, x, layer_cache, carry_extra)
        for key, t in new.items():
            if t is not layer_cache[key]:
                cache[key][i].copy_(t)
    return x, cache
