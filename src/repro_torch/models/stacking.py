"""Layer stacking (counterpart of repro/models/stacking.py).

The reference stacks every layer's parameters along a leading axis and
scans over them (constant compile time in depth). PyTorch runs eagerly,
so the port keeps the layers in an ``nn.ModuleList`` and loops over it
in the same order. The stacked layout still matters where parameters
leave the model: the training state, the optimizer's arithmetic and the
checkpoint hold the reference's stacked tree (:func:`stack_params`), and
the model's parameters are bound to views of it (:func:`bind_params`).

``remat`` is the reference's activation-checkpointing policy:
``"full"`` recomputes a whole layer in the backward pass
(``torch.utils.checkpoint``), ``"dots"`` keeps the matmul outputs and
recomputes the rest (a selective checkpoint, as ``checkpoint_dots``),
``"dots_no_batch"`` keeps only the matmuls without batch dimensions,
``"none"`` keeps everything. It acts only where autograd records: a
forward under ``no_grad`` or ``inference_mode`` runs the layer as is.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: parameter groups the reference stacks on a leading layer axis (a
#: RecurrentGemma group nests its ``r1``, ``r2`` and ``a`` layers)
STACKED_GROUPS = ("dense_layers", "moe_layers", "layers", "groups", "tail",
                  "enc_layers", "dec_layers")
#: reference tree key -> port parameter name where the two differ
PARAM_RENAMES = {"unembed": "unembed_w"}
_TREE_KEYS = {v: k for k, v in PARAM_RENAMES.items()}

_aten = torch.ops.aten
#: the matmuls each selective policy keeps (``x @ w`` on a 3-D ``x``
#: dispatches as ``mm``; batched products such as attention's as ``bmm``)
_SAVED_OPS = {
    "dots": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default),
    "dots_no_batch": (_aten.mm.default, _aten.addmm.default),
}


def _keep(ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def stacked_specs(layer_spec: Dict, n_layers: int) -> Dict:
    """Prepend an unsharded (layer) axis to every spec of the tree (its
    keys sorted, as the reference's ``jax.tree.map`` rebuilds them)."""
    from ..launch.mesh import P
    if isinstance(layer_spec, P):
        return P(None, *layer_spec)
    return {k: stacked_specs(layer_spec[k], n_layers)
            for k in sorted(layer_spec)}


def remat_wrap(fn: Callable, policy: str) -> Callable:
    """``fn`` under the activation-checkpointing ``policy``."""
    if policy == "none":
        return fn
    if policy == "full":
        context_fn = None
    elif policy in _SAVED_OPS:
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _keep(_SAVED_OPS[policy]))
    else:
        raise ValueError(f"unknown remat policy {policy}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


def scan_layers(block_fn: Callable, layers: Iterable, x: torch.Tensor,
                remat: str = "none", carry_extra=None) -> torch.Tensor:
    """x flows through the layers in order; block_fn(layer, x, extra) ->
    x, each layer under the ``remat`` policy."""
    fn = remat_wrap(block_fn, remat)
    for layer in layers:
        x = fn(layer, x, carry_extra)
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


# ------------------------------------------------------ the stacked tree
def tree_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A port parameter name's path in the reference's stacked tree and
    its layer index (``None`` outside the stacked groups):
    ``dense_layers.3.attn.wq`` -> (("dense_layers", "attn", "wq"), 3)."""
    parts = name.split(".")
    if parts[0] in STACKED_GROUPS:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(_TREE_KEYS.get(name, name).split(".")), None


def stack_tree(named: Iterable[Tuple[str, torch.Tensor]]) -> Dict:
    """Nested dicts in the reference's layout from (port name, tensor)
    pairs: each stacked group's layers stacked on a new leading axis, in
    layer order (a copy; tensors are detached)."""
    layers: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}
    tree: Dict = {}
    for name, t in named:
        path, i = tree_path(name)
        if i is None:
            _put(tree, path, t.detach())
        else:
            layers.setdefault(path, {})[i] = t
    for path, by_layer in layers.items():
        _put(tree, path, torch.stack([by_layer[i].detach()
                                      for i in sorted(by_layer)]))
    return tree


def stack_params(model: torch.nn.Module) -> Dict:
    """The model's parameters as the reference's stacked tree (a copy)."""
    return stack_tree(model.named_parameters())


def bind_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Point every parameter of ``model`` at its slice of ``tree`` (the
    reference's stacked layout; no copy): the model then computes with
    those values, and autograd's gradients are those of ``tree``."""
    for name, p in model.named_parameters():
        path, i = tree_path(name)
        t = tree
        for key in path:
            t = t[key]
        view = t if i is None else t[i]
        if view.shape != p.shape or view.dtype != p.dtype \
                or view.device != p.device:
            raise ValueError(f"{name}: {tuple(view.shape)} {view.dtype} "
                             f"{view.device} does not fit {tuple(p.shape)} "
                             f"{p.dtype} {p.device}")
        if _is_dtensor(view) or _is_dtensor(p):
            # a DTensor (a sharded tree) cannot be a plain parameter's
            # data: the module takes a parameter of the view instead
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            module._parameters[leaf] = torch.nn.Parameter(
                view, requires_grad=p.requires_grad)
        else:
            p.data = view


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value
