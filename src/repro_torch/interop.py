"""Carry the reference's state into the port as plain data.

The Canal side has no weights. What the reference computes there, and
the port must accept, is:

* the lowered tables, as numpy arrays (``TABLE_PATHS`` names them);
* a placement ``{instance: (x, y)}`` — already plain data, taken as is
  by the port's router and emulator;
* a routing, as lists of node keys: ``Node.node_key()``, the structural
  identity (kind, tile, side/port, track, width) that the two IRs share
  (``Node`` itself hashes on a per-process id, which does not carry);
* a ready-valid fabric's state (FIFO slots, occupancy, memory), as numpy
  arrays (:func:`rv_state_from_numpy`).

The LM substrate has weights and configurations:

* a model configuration, as the dict ``dataclasses.asdict`` makes of the
  reference's ``ModelConfig`` (:func:`lm_config_from_fields`);
* a parameter tree, as nested dicts of numpy arrays with every layer
  stacked on a leading axis (:func:`lm_params_from_numpy`);
* a training state (parameters, optimizer state, step) in the same
  stacked layout (:func:`train_state_from_numpy`).

Everything here takes numpy arrays, dicts and tuples, never objects of
the reference package, and builds the port's objects from them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.graph import Interconnect
from .core.pnr.driver import PnRResult
from .core.pnr.packing import pack
from .core.pnr.route import (RoutedNet, RoutingResources, RoutingResult,
                             _net_delay)
from .core.pnr.timing import sta_critical_path
from .models.config import (EncDecConfig, HybridConfig, ModelConfig,
                            MoEConfig, SSMConfig, VLMConfig)
from .models.stacking import PARAM_RENAMES, STACKED_GROUPS

NodeKey = Tuple
#: one routed net: (name, source key, sink keys, tree edges (parent, child))
NetKeys = Tuple[str, NodeKey, Sequence[NodeKey],
                Sequence[Tuple[NodeKey, NodeKey]]]

#: attribute paths of a lowered fabric's tables, the same in both packages
TABLE_PATHS = (
    "arrays.src", "arrays.fanin_count", "arrays.config_slot",
    "arrays.is_reg", "arrays.is_driven", "arrays.reg_ids", "arrays.reg_src",
    "width_mask", "pe_in", "pe_out", "io_in_nodes", "io_out_nodes",
    "mem_in", "mem_out", "fused_tables.keep", "fused_tables.pin_mask",
    "fused_tables.pe_in", "fused_tables.pe_res_idx",
    "stream_tables.pin_src", "stream_tables.reg_src",
    "stream_tables.mem_in", "stream_tables.io_out",
)


def fabric_tables(fab) -> Dict[str, np.ndarray]:
    """The port fabric's tables by ``TABLE_PATHS`` name."""
    out = {}
    for path in TABLE_PATHS:
        head, _, leaf = path.rpartition(".")
        obj = fab
        if head == "stream_tables":
            obj = fab.stream_tables()
        elif head:
            obj = getattr(fab, head)
        out[path] = np.asarray(obj[leaf] if isinstance(obj, dict)
                               else getattr(obj, leaf))
    return out


def check_tables(fab, tables: Mapping[str, np.ndarray]) -> None:
    """Hold the port fabric's tables against ``tables`` (the reference's,
    as numpy, keyed by ``TABLE_PATHS``); raise ``ValueError`` naming the
    first table that differs."""
    mine = fabric_tables(fab)
    for path in TABLE_PATHS:
        if not np.array_equal(mine[path], np.asarray(tables[path])):
            raise ValueError(f"lowered table {path} differs")


def _key_index(res: RoutingResources) -> Dict[NodeKey, int]:
    index = {node.node_key(): i for i, node in enumerate(res.nodes)}
    if len(index) != len(res.nodes):
        raise ValueError("node keys are not unique in this interconnect")
    return index


def routing_keys(routing: RoutingResult) -> List[NetKeys]:
    """A port routing as plain node-key data (the inverse of
    :func:`routing_from_keys`)."""
    nodes = routing.resources.nodes
    return [(net.name, nodes[net.src].node_key(),
             [nodes[s].node_key() for s in net.sinks],
             sorted((nodes[p].node_key(), nodes[c].node_key())
                    for p, c in net.edges()))
            for net in routing.nets]


def routing_from_keys(res: RoutingResources,
                      nets: Sequence[NetKeys]) -> RoutingResult:
    """Build the port's :class:`RoutingResult` from node-key routes (no
    negotiation iterations of its own)."""
    index = _key_index(res)
    out = []
    for name, src, sinks, edges in nets:
        net = RoutedNet(name, index[src], [index[s] for s in sinks])
        net.tree = {index[c]: index[p] for p, c in edges}
        net.delay = _net_delay(res, net)
        out.append(net)
    return RoutingResult(out, 0, [], res)


def pnr_result(ic: Interconnect, app, placement: Mapping[str, Tuple[int,
                                                                      int]],
               nets: Sequence[NetKeys],
               resources: Optional[RoutingResources] = None) -> PnRResult:
    """The port's :class:`PnRResult` for a placement and node-key routing
    computed elsewhere: packs ``app`` with the port's packer and times the
    routing with the port's STA, so bitstream and emulation can run on
    it."""
    packed = pack(app)
    res = resources or RoutingResources(ic)
    routing = routing_from_keys(res, nets)
    placement = {k: (int(x), int(y)) for k, (x, y) in placement.items()}
    timing = sta_critical_path(packed, routing, placement)
    return PnRResult(success=True, placement=placement, packed=packed,
                     routing=routing, timing=timing,
                     wirelength=routing.total_wirelength())


#: the ready-valid fabric's state, the same keys in both packages
RV_STATE_KEYS = ("slots", "occ", "mem")


def rv_state_from_numpy(fab, state: Mapping[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """An ``RVFabric`` state (FIFO ``slots`` (R, 2), occupancy ``occ``
    (R,), ``mem``) given as numpy arrays — the reference's, say — as the
    port fabric's int32 tensors on its device."""
    return {k: torch.as_tensor(np.array(state[k], dtype=np.int32),
                               device=fab.device)
            for k in RV_STATE_KEYS}


def rv_state_to_numpy(state: Mapping[str, torch.Tensor]
                      ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`rv_state_from_numpy`: a port ``RVFabric``
    state as int32 numpy arrays."""
    return {k: np.asarray(state[k].cpu().numpy(), dtype=np.int32)
            for k in RV_STATE_KEYS}


# ------------------------------------------------------------ LM substrate
#: the reference's ``attn_impl`` names -> the port's
ATTN_IMPL_NAMES = {"xla": "plain", "pallas": "kernel"}
_SUB_CONFIGS = {"moe": MoEConfig, "ssm": SSMConfig, "hybrid": HybridConfig,
                "encdec": EncDecConfig, "vlm": VLMConfig}


def lm_config_from_fields(fields: Mapping) -> ModelConfig:
    """The port's :class:`ModelConfig` from the reference's as a plain
    dict (``dataclasses.asdict``); ``attn_impl`` "xla"/"pallas" become
    "plain"/"kernel"."""
    kw = dict(fields)
    for name, cls in _SUB_CONFIGS.items():
        if kw.get(name) is not None:
            kw[name] = cls(**kw[name])
    kw["attn_impl"] = ATTN_IMPL_NAMES[kw["attn_impl"]]
    return ModelConfig(**kw)


def _flatten(tree: Mapping, prefix: str = ""):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def lm_params_from_numpy(cfg: ModelConfig,
                         tree: Mapping) -> Dict[str, torch.Tensor]:
    """The port model's state (for ``load_state_dict``) from the
    reference's parameter tree as nested dicts of numpy arrays.

    Stacked groups are unstacked into ``<group>.<i>.`` keys; values go
    through float32 (numpy holds the reference's bf16 as
    ``ml_dtypes.bfloat16``), so the cast to the port's dtype is exact.
    Raises ``ValueError`` on a missing or extra key, or a shape that
    differs.
    """
    from .models import build_model

    template = build_model(cfg, "meta").state_dict()
    state = {}
    for key, arr in _flatten(tree):
        arr = np.asarray(arr)
        head, _, rest = key.partition(".")
        if head in STACKED_GROUPS:
            for i in range(arr.shape[0]):
                state[f"{head}.{i}.{rest}"] = arr[i]
        else:
            state[PARAM_RENAMES.get(key, key)] = arr
    missing = sorted(template.keys() - state.keys())
    extra = sorted(state.keys() - template.keys())
    if missing or extra:
        raise ValueError(f"parameter tree does not fit {cfg.name}: "
                         f"missing {missing}, extra {extra}")
    out = {}
    for key, want in template.items():
        arr = state[key]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(want.shape)}")
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            want.dtype)
    return out


# ---------------------------------------------------------- training state
def _leaf_tensor(arr, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A numpy leaf as a tensor. A float leaf goes through float32, so
    the reference's bf16 (``ml_dtypes.bfloat16`` in numpy) casts
    exactly; ``dtype`` defaults to bf16 for such a leaf, else to the
    array's own."""
    arr = np.asarray(arr)
    if str(arr.dtype) == "bfloat16":
        t = torch.from_numpy(np.asarray(arr, np.float32))
        dtype = dtype or torch.bfloat16
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def _leaf_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_from_numpy(cfg: ModelConfig, tree: Mapping,
                           device=None):
    """The port's :class:`~repro_torch.train.step.TrainState` from the
    reference's as nested dicts of numpy arrays (``{"params", "opt",
    "step"}``, every layer stacked on a leading axis, as
    ``jax.tree.map(np.asarray, state._asdict())`` gives it).

    Parameters take the dtypes of the model of ``cfg`` and must fit it
    (the reference's stacked tree of it, key for key and shape for
    shape: ``ValueError`` otherwise); optimizer leaves keep their dtype.
    """
    from .models import build_model
    from .models.stacking import stack_params
    from .train.step import TrainState
    from .tree import tree_items, tree_map, tree_unflatten

    template = stack_params(build_model(cfg, "meta"))
    want = dict(tree_items(template))
    got = dict(tree_items(tree["params"]))
    if want.keys() != got.keys():
        raise ValueError(f"parameter tree does not fit {cfg.name}: "
                         f"missing {sorted(want.keys() - got.keys())}, "
                         f"extra {sorted(got.keys() - want.keys())}")
    for key, t in want.items():
        if tuple(np.shape(got[key])) != tuple(t.shape):
            raise ValueError(f"{key}: shape {tuple(np.shape(got[key]))}, "
                             f"expected {tuple(t.shape)}")
    return TrainState(
        params=tree_unflatten(template, [
            _leaf_tensor(got[key], t.dtype, device)
            for key, t in want.items()]),
        opt=tree_map(lambda a: _leaf_tensor(a, None, device), tree["opt"]),
        step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                          device=device))


def train_state_to_numpy(state) -> Dict:
    """The inverse of :func:`train_state_from_numpy`: ``{"params",
    "opt", "step"}`` as nested dicts of numpy arrays in the reference's
    stacked layout, bf16 leaves as float32 (exact)."""
    from .tree import tree_map

    return {"params": tree_map(_leaf_numpy, state.params),
            "opt": tree_map(_leaf_numpy, state.opt),
            "step": np.int32(int(state.step))}
