"""Per-device cost of a PyTorch program (counterpart of
repro/roofline/hlo_cost.py).

The reference lowers a step to partitioned HLO and walks its text; the
port counts the aten ops one rank runs, as they run, under a
``TorchDispatchMode`` (:class:`CostCounter`). Its :meth:`totals` has the
reference's keys: ``flops``, ``bytes``, ``link_bytes``,
``collectives_by_kind`` and ``n_collective_ops``.

* **FLOPs**: 2 x output x contracted dims for the matmul family (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, what ``einsum`` lowers to,
  ``convolution``), the reference's ``dot`` rule, read from
  ``torch.utils.flop_counter``'s registry (``FlopCounterMode``'s
  numbers). The two hand-written kernels register their own formula
  there (``kernels/flash_attention.py``, ``kernels/ssd_scan.py``); the
  reference counts 0 for a Pallas custom call.
* **Bytes**: the reference's HBM model mapped onto aten ops: operands
  and outputs for matmuls, gather, scatter, index, sort, the kernels and
  collectives; the output alone for every other op that makes a tensor
  (reductions, cat, pad, elementwise); nothing for views and for
  allocations that write nothing (``empty``).
* **Collectives**: one record of kind, output bytes and group size for
  each functional collective; link bytes by the reference's ring factors
  (:func:`~repro_torch.roofline.hlo_parse.link_traffic_bytes`).

The counter sees the *local* op of each rank: an op on a ``DTensor``
returns ``NotImplemented`` here, so DTensor runs first and its local
ops and collectives come back through the mode. There is no loop
multiplier, which the reference needs because a ``while`` body appears
once in HLO: eager dispatch runs every iteration, and the recompute of
``torch.utils.checkpoint`` is counted as it runs in the backward pass.

The counter also tracks the bytes that live tensors hold
(:attr:`CostCounter.peak_bytes`): every storage an op makes is added
when it appears and taken off when it is freed, on top of the storages
registered as arguments (:meth:`CostCounter.hold`).
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .hlo_parse import link_traffic_bytes

_aten = torch.ops.aten


def _packets(*names) -> set:
    return {getattr(_aten, n) for n in names if hasattr(_aten, n)}


#: operands + outputs (the reference's ``_HBM_OPS``; also every op of
#: the ``canal`` namespace, the hand-written kernels)
HBM_OPS = _packets(
    "mm", "bmm", "addmm", "baddbmm", "matmul", "convolution",
    "convolution_backward", "gather", "scatter", "scatter_add",
    "scatter_reduce", "index", "index_put", "index_put_", "_index_put_impl_",
    "index_select", "index_add", "embedding", "embedding_dense_backward",
    "sort", "topk", "argsort", "searchsorted")
#: allocate without writing
NO_WRITE_OPS = _packets("empty", "empty_like", "empty_strided", "new_empty",
                        "new_empty_strided", "_local_scalar_dense",
                        "_unsafe_view", "lift_fresh", "alias", "detach")
#: functional collectives -> the reference's kind names
COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args[1:]:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if hasattr(a, "size") and not isinstance(a, torch.Tensor):
            return a.size()
    return 1


class CostCounter(TorchDispatchMode):
    """Counts what one rank's ops cost while the mode is active (see the
    module docstring). ``n_ops`` is the number of aten ops counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.records: List[Dict] = []
        self.flops_by_op: Dict[str, float] = defaultdict(float)
        self.op_names: List[str] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}

    # ------------------------------------------------------- live bytes
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        size = st.nbytes()
        self._seen[key] = size
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    def hold(self, tensors: Iterable[torch.Tensor]) -> int:
        """Count these (local) tensors' storages as live from now on (a
        step's arguments); returns their bytes."""
        before = self.live_bytes
        for t in tensors:
            if hasattr(t, "to_local"):
                t = t.to_local()
            self._track(t)
        return self.live_bytes - before

    def reset_peak(self) -> None:
        self.peak_bytes = self.live_bytes

    # ----------------------------------------------------------- counting
    def __enter__(self):
        # DTensor runs each op once more on fake tensors of the global
        # shape to learn the output's metadata; that run is not the
        # rank's work, so the counter pauses for it
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        meta = ShardingPropagator._propagate_tensor_meta_non_cached
        self._patched = (ShardingPropagator, meta)

        def paused(prop, *args, **kwargs):
            self._paused += 1
            try:
                return meta(prop, *args, **kwargs)
            finally:
                self._paused -= 1

        self._paused = 0
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        return super().__enter__()

    def __exit__(self, *exc):
        cls, meta = self._patched
        cls._propagate_tensor_meta_non_cached = meta
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # prim ops (``prim.device``) read metadata; a fake tensor asks
        # them where a real one does not
        if not self._paused and func.namespace != "prim":
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        self.n_ops += 1
        self.op_names.append(str(packet))
        outs = _tensors(out)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.flops_by_op[str(packet)] += f
        name = packet.__name__
        kind = COLLECTIVES.get(name)
        if kind is not None:
            b = sum(_nbytes(t) for t in outs)
            self.records.append({"kind": kind, "bytes": b,
                                 "group": max(_group_size(args), 1)})
            self.bytes += b + sum(_nbytes(t) for t in _tensors(args))
        elif func.is_view or packet in NO_WRITE_OPS:
            pass
        elif packet in HBM_OPS or func.namespace == "canal":
            self.bytes += sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in _tensors((args, kwargs)))
        else:
            self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            if not func.is_view:
                self._track(t)

    def totals(self) -> Dict:
        link_bytes, by_kind = link_traffic_bytes(self.records)
        return {"flops": self.flops, "bytes": self.bytes,
                "link_bytes": link_bytes,
                "collectives_by_kind": by_kind,
                "n_collective_ops": len(self.records)}
