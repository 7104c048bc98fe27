"""Training step (counterpart of repro/train/step.py): loss, grads,
optimizer update, with microbatch gradient accumulation, mixed precision
(bf16 params/activations, f32 loss and optimizer math) and optional int8
error-feedback gradient compression on the cross-pod reduction
(runtime/compression.py).

The training state holds the parameters as the reference does: one tree
with every layer stacked on a leading axis
(:func:`repro_torch.models.stacking.stack_params`). Each step binds the
model's parameters to views of that tree
(:func:`~repro_torch.models.stacking.bind_params`), takes the gradients
with autograd and returns a new state, so a restored checkpoint is just
another state. The step trains the models' plain branch, as the
reference does: the hand-written kernels have no backward, so a model
with ``attn_impl="kernel"`` is refused (the reference's Pallas branch
fails under ``jax.grad`` too). Every family trains, as in the
reference: the batch goes to ``model.hidden`` whole, so a VLM batch's
``patches`` and a Whisper batch's ``frames`` reach the model.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..launch.mesh import gather_dim, linear
from ..models.stacking import bind_params, stack_params, stack_tree
from ..optim import Optimizer, global_norm
from ..tree import tree_map


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor


def init_train_state(model, optimizer: Optimizer,
                     generator: torch.Generator) -> TrainState:
    """Draw the model's weights from ``generator`` and take them as the
    stacked parameter tree (the model is bound to it)."""
    model.init_params(generator)
    params = stack_params(model)
    bind_params(model, params)
    return TrainState(params=params, opt=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=model.device))


def train_state_specs(model, optimizer: Optimizer) -> TrainState:
    """The reference's partition specs of the training state."""
    from ..launch.mesh import P
    p_specs = model.param_specs()
    return TrainState(params=p_specs, opt=optimizer.state_specs(p_specs),
                      step=P())


def _chunk_ce(h: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              vocab: int, batch_axes=("data",)):
    logits = linear(h, w, "col", batch_axes).float()  # (B, chunk, Vpad)
    if logits.shape[-1] > vocab:                    # mask pad logits
        v_ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(v_ids[None, None] < vocab, logits,
                             torch.full_like(logits, -1e30))
    # on a mesh the vocab is gathered here, so that the gradient comes
    # back to the vocab-sharded product in its shards
    logits = gather_dim(logits, -1)
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, y.clamp(min=0)[..., None])[..., 0]
    mask = (y >= 0).float()
    hits = ((torch.argmax(logits, -1) == y) * mask).sum()
    return -(ll * mask).sum(), mask.sum(), hits


def loss_fn(model, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Sequence-chunked cross entropy: the (B, S, V) logits tensor never
    materializes. Hidden states are unembedded chunk by chunk, each
    chunk recomputed in the backward pass (``torch.utils.checkpoint``).
    Binds the model to ``params`` first."""
    cfg = model.cfg
    bind_params(model, params)
    hidden = model.hidden(batch)                    # (B, S, D)
    w = model.unembed().to(cfg.adtype)              # (D, V)
    labels = batch["labels"]
    b, s, d = hidden.shape
    chunk = min(cfg.ce_seq_chunk or s, s)
    if s % chunk:
        chunk = s                                   # fallback: one chunk

    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    nll, n, hits = zero, zero, zero
    for i in range(0, s, chunk):
        args = (hidden[:, i:i + chunk], labels[:, i:i + chunk], w,
                cfg.vocab_size, cfg.batch_axes)
        if torch.is_grad_enabled():
            c_nll, c_n, c_hits = checkpoint(_chunk_ce, *args,
                                            use_reentrant=False)
        else:
            c_nll, c_n, c_hits = _chunk_ce(*args)
        nll, n, hits = nll + c_nll, n + c_n, hits + c_hits
    loss = nll / torch.clamp(n, min=1.0)
    acc = hits / torch.clamp(n, min=1.0)
    return loss, {"loss": loss, "accuracy": acc}


def value_and_grad(model, params, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict, Any]:
    """(loss, metrics, grads) of :func:`loss_fn` at ``params``, the grads
    a tree like ``params`` in its dtypes (``jax.value_and_grad``'s
    counterpart). The model's parameters must require grad
    (:func:`make_train_step` turns that on). On a mesh each gradient is
    laid out as its parameter: a partial sum over the batch axes is
    reduced (scattered where the parameter is sharded)."""
    with torch.enable_grad():
        loss, metrics = loss_fn(model, params, batch)
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p)
             for (_, p), g in zip(named, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            stack_tree((name, g) for (name, _), g in zip(named, grads)))


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s placements where ``p`` is a DTensor."""
    placements = getattr(p, "placements", None)
    if placements is None or tuple(g.placements) == tuple(placements):
        return g
    return g.redistribute(p.device_mesh, placements)


def make_train_step(model, optimizer: Optimizer,
                    microbatches: int = 0,
                    grad_compression: Optional[str] = None,
                    group=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    The metrics are the reference's (``loss``, ``accuracy``) and the
    gradients' global norm before clipping (``grad_norm``).

    microbatches > 1 splits the batch and accumulates f32 grads (a
    memory knob); grad_compression="int8_ef" compresses the gradient
    all-reduce over the ``torch.distributed`` process ``group`` (where
    the reference reduces over its pod mesh axis; without a group it is
    skipped, as the reference skips it without one). Turns on gradients
    for ``model``'s parameters.
    """
    if model.cfg.attn_impl == "kernel":
        raise ValueError(
            "attn_impl='kernel' cannot train: the flash_attention and "
            "ssd_scan kernels have no backward (the reference's Pallas "
            "branch fails under jax.grad too); train the plain branch")
    model.requires_grad_(True)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState,
                                                            Dict]:
        params = state.params
        if microbatches and microbatches > 1:
            def split(x, i):
                b = x.shape[0] // microbatches
                return x[i * b:(i + 1) * b]

            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            zero = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            metrics = {"loss": zero, "accuracy": zero}
            for i in range(microbatches):
                _, m, g = value_and_grad(model, params, {
                    k: split(v, i) for k, v in batch.items()})
                grads = tree_map(lambda a, b_: a + b_.float(), grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {k: v / microbatches for k, v in metrics.items()}
        else:
            _, metrics, grads = value_and_grad(model, params, batch)

        if grad_compression == "int8_ef" and group is not None:
            from ..runtime.compression import compressed_grad_sync
            grads = compressed_grad_sync(grads, group)
        metrics["grad_norm"] = global_norm(grads)

        updates, new_opt = optimizer.update(grads, state.opt, params,
                                            state.step)
        del grads
        new_params = tree_map(lambda p, u: p + u, params, updates)
        bind_params(model, new_params)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step
