"""Optimizers (counterpart of repro/optim/optimizers.py): AdamW (f32
states) and Adafactor (factored second moment, bf16 first moment), with
global-norm clipping.

They are plain ``init``/``update`` functions over the reference's
stacked parameter tree (:mod:`repro_torch.tree`), not
``torch.optim.Optimizer`` subclasses: the state is a value that the
training state carries, the checkpoint writes leaf for leaf in the
reference's layout and the supervisor restores as a new value, and
Adafactor factors each *stacked* matrix (a layer's norm scale is a row
of an (L, d) matrix in the reference, so it is factored there too). The
arithmetic is the reference's, in its order and dtypes; in particular
weight decay is added to ``delta`` and ``(-lr * delta)`` is cast to the
parameter's dtype before it is added (``torch.optim.AdamW`` decays the
parameter separately, which rounds otherwise in bf16). ``state_specs``
maps the parameters' partition specs to the state's, as the
reference's does; on a mesh the state's leaves are DTensors of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import torch

from ..launch.mesh import P
from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    #: (grads, state, params, step) -> (updates, new state)
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    #: param spec tree -> state spec tree
    state_specs: Optional[Callable[[Any], Any]] = None


def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf; on a mesh each leaf's sum of squares is
    reduced over the ranks before the leaves are added (a partial sum
    and a replicated one do not add as DTensors)."""
    return torch.sqrt(sum(_summed(torch.sum(torch.square(x.float())))
                          for x in tree_leaves(tree)))


def clip_scale(grads, max_norm: float) -> torch.Tensor:
    """The float32 factor that scales grads to a global norm of at most
    ``max_norm`` (the reference's ``clip_by_global_norm``). The optimizers
    multiply each leaf by it as they update it (the product the
    reference's bf16 x f32 promotes to), so no float32 copy of every
    gradient is held at once."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _lr_fn(lr):
    return lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=torch.float32,
                                  device=torch.as_tensor(step).device))


def _summed(t: torch.Tensor) -> torch.Tensor:
    """A sum or mean over a dim sharded on a mesh is a partial one on
    each rank: it is reduced here (what comes after needs the whole
    value). A plain tensor as it is."""
    from torch.distributed.tensor import Partial, Replicate
    pls = getattr(t, "placements", None)
    if pls is None or not any(isinstance(p, Partial) for p in pls):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if isinstance(
        p, Partial) else p for p in pls])


def _as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in ``like``'s placements, so that in-place arithmetic may
    combine them on a mesh; plain tensors as they are."""
    pls = getattr(like, "placements", None)
    if pls is None or tuple(t.placements) == tuple(pls):
        return t
    return t.redistribute(like.device_mesh, pls)


def _unzip(out, n: int):
    return tuple(tree_map(lambda o: o[i], out) for i in range(n))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        scale = clip_scale(grads, clip_norm)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        lr_t = lr_fn(step)

        def upd(g, m, v, p):
            gf = g.float() * scale
            m_new = b1 * m + (1 - b1) * gf
            v_new = b2 * v + (1 - b2) * gf * gf
            m_hat = m_new / (1 - b1 ** t)
            v_hat = v_new / (1 - b2 ** t)
            delta = m_hat / (torch.sqrt(v_hat) + eps) \
                + weight_decay * p.float()
            return (-lr_t * delta).to(p.dtype), m_new, v_new

        updates, m, v = _unzip(tree_map(upd, grads, state["m"], state["v"],
                                        params), 3)
        return updates, {"m": m, "v": v}

    def state_specs(param_specs):
        return {"m": param_specs, "v": param_specs}

    return Optimizer(init, update, state_specs)


# ---------------------------------------------------------------------------
# Adafactor (factored v for matrices, bf16 m)
# ---------------------------------------------------------------------------

def adafactor(lr, b1: float = 0.9, decay: float = 0.99, eps: float = 1e-30,
              weight_decay: float = 0.0, clip_norm: float = 1.0
              ) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def per_param(p):
            def zeros(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=p.device)
            if p.ndim >= 2:
                return {"m": zeros(p.shape, torch.bfloat16),
                        "vr": zeros(p.shape[:-1], torch.float32),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:],
                                    torch.float32)}
            return {"m": zeros(p.shape, torch.bfloat16),
                    "v": zeros(p.shape, torch.float32)}

        return tree_map(per_param, params)

    def update(grads, state, params, step):
        scale = clip_scale(grads, clip_norm)
        lr_t = lr_fn(step)

        def upd(g, st, p):
            # the reference's arithmetic, op for op, with each temporary
            # written over in place once it is not read again: a stacked
            # leaf of 1 G elements (Kimi K2's embedding, Granite's experts)
            # needs ~12 bytes an element of float32 scratch, not ~24
            gf = g.to(torch.float32, copy=True).mul_(scale)
            g2 = torch.mul(gf, gf).add_(eps)
            if p.ndim >= 2:
                vr = _summed(decay * st["vr"]
                             + (1 - decay) * torch.mean(g2, dim=-1))
                vc = _summed(decay * st["vc"]
                             + (1 - decay) * torch.mean(g2, dim=-2))
                del g2
                precond = _as(torch.mul(vr[..., None], vc[..., None, :]),
                              gf).div_(
                    torch.clamp(_summed(torch.mean(vr, dim=-1, keepdim=True))
                                [..., None], min=eps))
                precond.clamp_(min=eps).rsqrt_().mul_(gf)
                new_st = {"vr": vr, "vc": vc}
            else:
                v = g2.mul_(1 - decay).add_(decay * st["v"])
                precond = torch.clamp(v, min=eps).rsqrt_().mul_(gf)
                new_st = {"v": v}
            del gf
            m = st["m"].float().mul_(b1).add_(precond.mul_(1 - b1))
            del precond
            new_st["m"] = m.to(torch.bfloat16)
            delta = m.add_(weight_decay * p.float())
            return delta.mul_(-lr_t).to(p.dtype), new_st

        return _unzip(tree_map(upd, grads, state, params), 2)

    def state_specs(param_specs):
        def per_spec(s):
            if len(s) >= 2:
                return {"m": s, "vr": P(*s[:-1]),
                        "vc": P(*(s[:-2] + (s[-1],)))}
            return {"m": s, "v": s}

        def sorted_map(tree):
            # keys sorted, as the reference's jax.tree.map rebuilds them
            if isinstance(tree, P):
                return per_spec(tree)
            return {k: sorted_map(tree[k]) for k in sorted(tree)}

        return sorted_map(param_specs)

    return Optimizer(init, update, state_specs)
