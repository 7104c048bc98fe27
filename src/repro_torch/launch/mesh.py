"""Production mesh construction and partition specs (counterpart of
repro/launch/mesh.py).

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the ``pod`` axis is pure data parallelism over
the slower inter-pod links, which is why gradient compression targets
it (runtime/compression.py).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``. Over a real
process group of the mesh's size it is that group's; otherwise it is
over a ``"fake"`` group of that size (rank 0 of it), which moves no data
and serves the dry run (:mod:`repro_torch.launch.dryrun`), where every
tensor is a fake tensor. :func:`make_production_mesh` sets that group
up and :func:`release_mesh` tears it down.

A partition spec is :class:`P`, the port's own: a tuple with one entry
a tensor dim, each a mesh axis name, a tuple of names, or ``None``, as
``jax.sharding.PartitionSpec``. :func:`tree_shardings` maps a spec tree
to DTensor placements, and :func:`constrain` is the port's
``with_sharding_constraint``: it redistributes a ``DTensor`` to a spec
and leaves any other tensor as it is (off a mesh it is a no-op, as the
reference's is without a mesh context).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

#: the fake process group this module set up, if any
_FAKE = {"owned": False}


class P(tuple):
    """A partition spec: one entry a tensor dim (a mesh axis, a tuple of
    axes, or ``None``); dims past its length are unsharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise ValueError(f"a {n}-rank mesh over a process group of "
                             f"{dist.get_world_size()}")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        _FAKE["owned"] = True
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda",
                   data_axis: Optional[int] = None):
    """(data, model) mesh over the current process group (tests,
    examples); ``data_axis`` defaults to the group's size over
    ``model_axis``. Without a process group it is over a fake one of
    ``data_axis * model_axis`` ranks."""
    n = dist.get_world_size() if dist.is_initialized() else None
    data = data_axis or max(1, (n or model_axis) // model_axis)
    return _make_mesh((data, model_axis), ("data", "model"), device_type)


def release_mesh() -> None:
    """Destroy the fake process group :func:`make_production_mesh` set up
    (a real group is the caller's to destroy)."""
    if _FAKE["owned"] and dist.is_initialized():
        dist.destroy_process_group()
    _FAKE["owned"] = False


def batch_spec(mesh) -> P:
    """Batch dim sharded over every data-parallel axis present."""
    axes = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    return P(tuple(axes) if len(axes) > 1 else axes[0])


def logical_to_physical(mesh, spec: P) -> P:
    """Map canonical ('data'/'model') specs onto this mesh: on the
    multi-pod mesh, parameters stay sharded only over (data, model) --
    the pod axis replicates them (pure DP)."""
    return spec


def placements(mesh, spec: P, shape: Optional[Sequence[int]] = None
               ) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh axis that spec entry ``d`` names, ``Replicate()`` elsewhere.
    Axes the mesh lacks are dropped, and so, given the tensor's
    ``shape``, is an axis whose size does not divide its dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        size = shape[d] if shape is not None else None
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis not in names:
                continue
            n = mesh.size(names.index(axis))
            if size is not None:
                if size % n:
                    continue
                size //= n
            out[names.index(axis)] = Shard(d)
    return out


class NamedSharding(NamedTuple):
    """A spec bound to a mesh: what a tensor of that spec looks like
    there (``placements``)."""
    mesh: object
    spec: P

    def placements(self, shape=None) -> List:
        return placements(self.mesh, self.spec, shape)


def sharding(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def tree_shardings(mesh, spec_tree):
    """Every ``P`` of ``spec_tree`` bound to ``mesh``, the tree kept
    (mappings and named tuples)."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(tree_shardings(mesh, v)
                                 for v in spec_tree))
    return spec_tree


def distribute(t: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    """``t`` (the same whole tensor on every rank) as a DTensor of
    sharding ``sh``, each rank keeping its own shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sh.mesh, sh.placements(t.shape),
                             src_data_rank=None)


def constrain(x, spec: P):
    """``x`` redistributed to ``spec`` if it is a DTensor (the port's
    ``with_sharding_constraint``); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(x.device_mesh, spec, x.shape)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def fit_split(x, dim: int, outer: int):
    """``x`` ready to have dim ``dim`` split into (``outer``, rest): a mesh
    axis that shards the dim stays only where its size divides
    ``outer`` (it then shards the outer part); any other is gathered. A
    plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    mesh, want, n = x.device_mesh, list(x.placements), outer
    for i, pl in enumerate(want):
        if isinstance(pl, Shard) and pl.dim == dim:
            if n % mesh.size(i):
                want[i] = Replicate()
            else:
                n //= mesh.size(i)
    if want == list(x.placements):
        return x
    return x.redistribute(mesh, want)


def fsdp(w):
    """A weight with its data-parallel shards gathered (``pod`` and
    ``data`` replicated, ``model`` kept), as XLA all-gathers an FSDP
    weight where it is used; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in ("pod", "data") else pl
            for i, pl in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def gather_dim(x, dim: int):
    """``x`` with dim ``dim`` whole on every rank (a plain tensor as it
    is)."""
    return fit_split(x, dim, 1)


def batch_axes_spec(cfg, ndim: int) -> P:
    """The batch dim on ``cfg.batch_axes``, the rest unsharded."""
    axes = tuple(cfg.batch_axes)
    return P(axes if len(axes) > 1 else axes[0], *([None] * (ndim - 1)))


def mesh_of(*tensors):
    """The device mesh of the first DTensor among ``tensors`` (None if
    none is one)."""
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


def axis_size(mesh, entry) -> int:
    """Ranks along a spec entry (an axis, a tuple of axes, or None) on
    ``mesh``; axes the mesh lacks count 1."""
    if mesh is None or entry is None:
        return 1
    names = list(mesh.mesh_dim_names)
    n = 1
    for axis in (entry if isinstance(entry, tuple) else (entry,)):
        if axis in names:
            n *= mesh.size(names.index(axis))
    return n


def run_local(fn, args: Sequence[torch.Tensor], in_specs: Sequence[P],
              out_specs, in_grads: Optional[Sequence] = None):
    """``fn(*args)`` on each rank's shards: DTensor ``args`` are first
    redistributed to ``in_specs``, and the outputs are taken as DTensors
    of ``out_specs`` (a spec, or a tuple of them for a tuple of outputs).
    A spec may also be a list of placements, e.g. to say ``Partial``.
    ``in_grads`` gives the placements of each argument's gradient where
    they differ from its spec: a weight that every rank of a batch shard
    uses gets a gradient ``Partial`` over the batch axes. Off a mesh it
    is ``fn(*args)``. The caller makes sure that every sharded dim
    divides evenly."""
    mesh = mesh_of(*args)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    def pl(spec):
        return spec if isinstance(spec, list) else placements(mesh, spec)

    outs = (tuple(pl(s) for s in out_specs)
            if isinstance(out_specs, tuple) and not isinstance(out_specs, P)
            else pl(out_specs))
    ins = tuple(pl(s) for s in in_specs)
    grads = (None if in_grads is None else
             tuple(i if g is None else pl(g) for i, g in zip(ins, in_grads)))
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def partial(mesh, spec: P, axes: Sequence[str]) -> List:
    """Placements of ``spec`` with ``Partial`` (a sum) on the mesh axes
    ``axes`` that the mesh has and the spec does not shard on."""
    from torch.distributed.tensor import Partial, Replicate
    out = placements(mesh, spec)
    names = list(mesh.mesh_dim_names)
    for a in axes:
        if a in names and mesh.size(names.index(a)) > 1 \
                and isinstance(out[names.index(a)], Replicate):
            out[names.index(a)] = Partial()
    return out


def linear(x: torch.Tensor, w: torch.Tensor, kind: str,
           batch_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """``x @ w`` for a weight ``w`` (in, out) of a linear layer; on a mesh
    Megatron-style, each rank multiplying its shards. ``kind="col"``: x
    replicated over ``model``, w's output columns on ``model`` (where they
    divide it), the output sharded like them; ``"row"``: x's last dim and
    w's input rows on ``model``, the output a ``Partial`` sum over it.
    The batch (x's first dim) stays on ``batch_axes``, and w's data
    shards are gathered first (FSDP). The gradients are placed
    explicitly: w's a ``Partial`` over the batch axes (reduce-scattered
    back to its shards), a column layer's x a ``Partial`` over
    ``model``."""
    mesh = mesh_of(x, w)
    if mesh is None:
        return x @ w
    w = fsdp(w)
    axes = tuple(batch_axes)
    ba = axes if len(axes) > 1 else axes[0]
    if x.shape[0] % axis_size(mesh, ba):
        ba = None
    lead = [None] * (x.dim() - 2)
    m = axis_size(mesh, "model")
    if kind == "col":
        f = "model" if m > 1 and w.shape[1] % m == 0 else None
        x_spec, w_spec, out = P(ba, *lead, None), P(None, f), P(ba, *lead, f)
        x_grad = partial(mesh, x_spec, ("model",) if f else ())
    else:
        f = "model" if m > 1 and w.shape[0] % m == 0 else None
        x_spec, w_spec = P(ba, *lead, f), P(f, None)
        out = partial(mesh, P(ba), ("model",) if f else ())
        x_grad = None
    w_grad = partial(mesh, w_spec, axes if ba else ())
    return run_local(torch.matmul, (x, w), (x_spec, w_spec), out,
                     in_grads=(x_grad, w_grad))
