"""Shared neural blocks of the LM substrate (counterpart of
repro/models/layers.py): RMSNorm, LayerNorm, RoPE, GQA attention
(full-sequence and cached), the SwiGLU/GELU MLP, the top-k mixture of
experts, the RG-LRU and the Mamba-2 (SSD) mixer.

Each block is an ``nn.Module`` that owns its parameters under the
reference's names (``wq``, ``w_in``, ``a_log``, ...) and draws them with
``init_params(generator)`` at the reference's scales (``init_mamba2``
builds and draws a mixer in one call, as the reference's does). The
apply functions (``rms_norm``, ``attention``, ``mlp``, ``mamba2``, ...)
are plain functions on tensors that take the module as ``p``, as the
reference's take their parameter dict. Parameters are made with
``requires_grad=False``, so that scoring and serving never record a
graph; the training step (``repro_torch.train.step``) turns gradients on
for the model it trains.

Numerics follow the reference step for step, since bf16 rounds wherever
a cast sits: ``rms_norm`` normalises in float32, casts to ``x.dtype`` and
only then multiplies by the scale; RoPE rotates concatenated halves with
float32 angles; attention scores are float32 and the probabilities are
cast to the activation dtype before the PV product; the MoE router and
the RG-LRU recurrence run in float32, the SSD too.

Every block also has ``spec_*`` (the reference's partition specs of its
parameters) and runs sharded when its tensors are DTensors on a mesh
(:mod:`repro_torch.launch.mesh`), as the reference's run under a mesh
context: linears Megatron-style (:func:`col`, :func:`row`), the
embedding vocab-parallel, attention, the MoE dispatch and combine and
the RG-LRU scan shard-local, the activations pinned to the batch axes
(:func:`shard_batch`) and, under ``attn_head_shard``, the heads to
``model``. Off a mesh each of these is the plain computation.
"""
from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops as kops
from ..launch.mesh import (P, axis_size, batch_axes_spec, constrain,
                           fit_split, fsdp, linear, mesh_of, partial,
                           placements, run_local)
from .config import ModelConfig


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


#: the most elements drawn at once: a larger tensor is drawn in slices
#: along its leading axis (Kimi K2's expert ``w_up``, 5.6 G elements,
#: would take a 22.5 GB float32 draw whole)
DRAW_ELEMENTS = 1 << 28


def _normal_(p: torch.Tensor, scale: float,
             generator: torch.Generator) -> None:
    """``p <- (N(0, 1) * scale)`` drawn in float32, cast to p's dtype.

    Up to ``DRAW_ELEMENTS`` elements in one draw; a larger tensor takes
    consecutive draws of whole leading-axis slices, so its values are
    still a function of the generator's seed alone."""
    rows = p.shape[0] if p.dim() else 1
    step = rows
    if p.numel() > DRAW_ELEMENTS:
        step = max(1, DRAW_ELEMENTS // max(1, p.numel() // rows))
    for i in range(0, rows, step):
        part = p[i:i + step] if step < rows else p
        draw = torch.randn(part.shape, generator=generator,
                           dtype=torch.float32, device=p.device)
        part.copy_(draw * scale)


def shard_batch(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pin the batch dim to the data-parallel mesh axes (and replicate the
    rest). Without this DTensor's propagation is free to replicate the
    activations (observed in the reference under GSPMD: 900 GiB/device
    stashes). No-op off a mesh."""
    return constrain(x, batch_axes_spec(cfg, x.dim()))


def col(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x @ w``, on a mesh column-parallel (:func:`~repro_torch.launch.
    mesh.linear`)."""
    return linear(x, w, "col", cfg.batch_axes)


def row(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``x @ w``, on a mesh row-parallel, its partial sums reduced into the
    batch layout (the Megatron all-reduce)."""
    return shard_batch(linear(x, w, "row", cfg.batch_axes), cfg)


def embed(table: torch.Tensor, ids: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """``table[ids]``; on a mesh vocab-parallel (Megatron): each rank
    looks its batch's ids up in its own rows of the vocab (``model``
    shards the table's first dim), zeros for ids outside them, and the
    partial rows are summed into the batch layout."""
    mesh = mesh_of(table, ids)
    if mesh is None:
        return table[ids]
    from torch.distributed.tensor import Shard
    ba = _batch_entry(cfg)
    if ids.shape[0] % axis_size(mesh, ba):
        ba = None
    names = mesh.mesh_dim_names
    split = [names[i] for i, pl in enumerate(fsdp(table).placements)
             if isinstance(pl, Shard) and pl.dim == 0]
    vocab = tuple(split) if len(split) > 1 else (split[0] if split
                                                   else None)
    rows = table.shape[0] // axis_size(mesh, vocab)
    lo = (sum(mesh.get_local_rank(a) * axis_size(mesh, tuple(split[j + 1:]))
              for j, a in enumerate(split)) * rows if split else 0)
    lead = [None] * (ids.dim() - 1)

    def local(t, i):
        if not split:
            return t[i]
        inside = (i >= lo) & (i < lo + t.shape[0])
        got = t[(i - lo).clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], got, got.new_zeros(()))

    t_spec = P(vocab, None)
    out = partial(mesh, P(ba, *lead, None), split)
    grad = partial(mesh, t_spec, (ba,) if isinstance(ba, str) else ba or ())
    return shard_batch(run_local(local, (fsdp(table), ids),
                                 (t_spec, P(ba, *lead)), out,
                                 in_grads=(grad, None)), cfg)


def _batch_entry(cfg: ModelConfig):
    axes = tuple(cfg.batch_axes)
    return axes if len(axes) > 1 else axes[0]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)


def spec_rmsnorm() -> dict:
    return {"scale": P(None)}


def rms_norm(x: torch.Tensor, p: RMSNorm, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p.scale.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


def spec_layernorm() -> dict:
    return {"scale": P(None), "bias": P(None)}


def layer_norm(x: torch.Tensor, p: LayerNorm,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and (biased) variance in float32; the normalised value is cast
    to x's dtype before the scale and bias, as the reference's."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p.scale.to(x.dtype) + p.bias.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D). positions: (..., S). Concatenated halves (not
    interleaved), frequencies ``exp(-log(theta) * i / half)``."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                    # (..., S, 1, h)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional qk-norm, optional sliding window)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
        self.wq = _param((d, hq * hd), cfg.pdtype, device)
        self.wk = _param((d, hkv * hd), cfg.pdtype, device)
        self.wv = _param((d, hkv * hd), cfg.pdtype, device)
        self.wo = _param((hq * hd, d), cfg.pdtype, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.pdtype, device)
            self.k_norm = RMSNorm(hd, cfg.pdtype, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        d, hqd = self.wq.shape
        s = 1.0 / math.sqrt(d)
        for w in (self.wq, self.wk, self.wv):
            _normal_(w, s, generator)
        _normal_(self.wo, 1.0 / math.sqrt(hqd), generator)
        if hasattr(self, "q_norm"):
            self.q_norm.init_params(generator)
            self.k_norm.init_params(generator)


def spec_attention(cfg: ModelConfig) -> dict:
    sp = {
        "wq": P("data", "model"),
        "wk": P("data", "model"),
        "wv": P("data", "model"),
        "wo": P("model", "data"),
    }
    if cfg.qk_norm:
        sp["q_norm"] = spec_rmsnorm()
        sp["k_norm"] = spec_rmsnorm()
    return sp


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    x = fit_split(x, -1, n_heads)
    return x.reshape(b, s, n_heads, hd).transpose(1, 2)      # (B,H,S,D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _sdpa(q, k, v, causal: bool, window: int, q_offset: int,
          impl: str = "plain", chunk: int = 2048,
          scores_f32: bool = True, gqa_mode: str = "repeat") -> torch.Tensor:
    """q: (B,Hq,Sq,D); k,v: (B,Hkv,Skv,D).

    ``impl="kernel"`` (full attention, no window) runs the hand-written
    flash kernel, whose query positions start at 0; the cached path never
    asks for it. GQA modes: "repeat" expands K/V to Hq heads (kv head
    ``h // rep`` serves q head ``h``); "grouped" reshapes queries to
    (B, Hkv, G, Sq, D) against unexpanded K/V. Sequences longer than
    ``chunk`` attend one query chunk at a time, so the (Sq, Skv) score
    matrix never materialises whole.
    """
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    if impl == "kernel" and window <= 0:
        return kops.flash_attention(q, k, v, causal=causal)
    grouped = (gqa_mode == "grouped" and hkv != hq)
    if not grouped and hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    g = hq // hkv
    skv = k.shape[2]
    acc_t = torch.float32 if scores_f32 else q.dtype
    ka = k.to(acc_t)
    ki = torch.arange(skv, device=q.device)[None, :]

    def attend(qc, qpos):
        cq = qc.shape[2]
        if grouped:
            qg = qc.reshape(b, hkv, g, cq, d).to(acc_t)
            scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, ka)
        else:
            scores = qc.to(acc_t) @ ka.transpose(-1, -2)
        scores = scores / math.sqrt(d)
        qi = qpos[:, None]
        mask = torch.ones((cq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qi >= ki
        if window > 0:
            mask &= ki > qi - window
        big_neg = -1e30 if scores_f32 else -3e38
        scores = torch.where(mask, scores, torch.full_like(scores, big_neg))
        probs = torch.softmax(scores.float(), dim=-1).to(qc.dtype)
        if grouped:
            out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v)
            return out.reshape(b, hq, cq, d)
        return probs @ v

    def positions(start, n):
        return torch.arange(n, device=q.device) + start + q_offset

    if chunk <= 0 or sq <= chunk:
        return attend(q, positions(0, sq))
    if sq % chunk:
        # largest divisor of sq no bigger than the requested chunk
        chunk = math.gcd(sq, chunk)
        if chunk < 128:
            return attend(q, positions(0, sq))
    return torch.cat([attend(q[:, :, i:i + chunk], positions(i, chunk))
                      for i in range(0, sq, chunk)], dim=2)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor,
              cache: Optional[Tuple] = None,
              window: int = 0) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Full-sequence (cache=None) or cached decode/prefill attention.

    cache = (k_cache, v_cache, index): k/v (B, Hkv, S_max, D), index an
    int. The new K/V are written into the cache tensors in place, at
    ``index`` clamped so that they fit (as ``dynamic_update_slice``
    clamps); query positions stay unclamped. Returns (out, (k_cache,
    v_cache, index + S)).
    """
    hq, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q = _split_heads(col(x, p.wq, cfg), hq, hd)
    k = _split_heads(col(x, p.wk, cfg), hkv, hd)
    v = _split_heads(col(x, p.wv, cfg), hkv, hd)
    if cfg.attn_head_shard and cache is None:
        # Megatron-style: heads on the model axis, head_dim whole, so the
        # qk and pv contractions are shard-local (no score all-reduce)
        ba = _batch_entry(cfg)
        q = constrain(q, P(ba, "model", None, None))
        k = constrain(k, P(ba, "model", None, None))
        v = constrain(v, P(ba, "model", None, None))
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    q = rope(q.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)
    k = rope(k.transpose(1, 2), positions, cfg.rope_theta).transpose(1, 2)

    if cache is None:
        out = sdpa(q, k, v, cfg, causal=True, window=window,
                   impl=cfg.attn_impl, gqa_mode=cfg.gqa_mode)
        new_cache = None
    else:
        k_c, v_c, idx = cache
        s, s_max = q.shape[2], k_c.shape[2]
        if s > s_max:
            raise ValueError(f"{s} new positions do not fit a cache of "
                             f"{s_max}")
        start = min(max(idx, 0), s_max - s)
        # the cached path always runs plain, grouped GQA (the reference's
        # decode layout: no K/V repeat over the whole cache)
        decode_gqa = ("grouped" if cfg.gqa_mode == "repeat"
                      else cfg.gqa_mode)
        out = run_cached(functools.partial(
            _cached_attend, start=start, idx=idx, window=window, cfg=cfg,
            gqa_mode=decode_gqa), q, k, v, k_c, v_c, cfg)
        new_cache = (k_c, v_c, idx + s)
    return row(_merge_heads(out), p.wo, cfg), new_cache


def sdpa(q, k, v, cfg: ModelConfig, causal: bool, window: int = 0,
         impl: str = "plain", gqa_mode: str = "repeat") -> torch.Tensor:
    """:func:`_sdpa` from position 0 at ``cfg``'s chunking; on a mesh
    shard-local, each rank attending its batch and heads."""
    fn = functools.partial(
        _sdpa, causal=causal, window=window, q_offset=0, impl=impl,
        chunk=cfg.attn_chunk, scores_f32=cfg.attn_scores_f32,
        gqa_mode=gqa_mode)
    if mesh_of(q, k, v) is None:
        return fn(q, k, v)
    k, v, spec = _local_heads(q, k, v, cfg)
    return run_local(fn, (q, k, v), (spec,) * 3, spec)


def _repeat_heads(k: torch.Tensor, rep: int) -> torch.Tensor:
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, rep, s, d).reshape(b, h * rep, s, d)


def _local_heads(q, k, v, cfg: ModelConfig):
    """k, v and the spec under which attention runs shard-local: the batch
    on the batch axes, the heads on ``model`` where the q heads divide
    it. Where the kv heads do not, k and v are first repeated to the q
    heads (kv head ``h // rep`` serves q head ``h``), so that they shard
    alike."""
    mesh = mesh_of(q, k, v)
    ba = _batch_entry(cfg)
    if q.shape[0] % axis_size(mesh, ba):
        ba = None
    m = axis_size(mesh, "model")
    heads = "model" if m > 1 and q.shape[1] % m == 0 else None
    if heads and k.shape[1] % m:
        rep = q.shape[1] // k.shape[1]
        k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    return k, v, P(ba, heads, None, None)


def _cache_batch(t: torch.Tensor):
    """The spec entry of the mesh axes that shard dim 0 (the batch) of a
    cache DTensor ``t``."""
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    on = tuple(names[i] for i, pl in enumerate(t.placements)
               if isinstance(pl, Shard) and pl.dim == 0)
    return on if len(on) > 1 else (on[0] if on else None)


def run_cached(fn, q, k, v, k_c, v_c, cfg: ModelConfig):
    """``fn(q, k, v, k_c, v_c, lo, group)``, cached attention,
    on each rank's shards: the cache stays as it is laid out (its writes
    land in place), the batch on the axes that shard the cache's batch
    dim and the cache's sequence (its slots) on those that shard its
    dim 2, ``lo`` the first slot of this rank's part and ``group`` the
    process group over which the ranks' partial softmax sums merge
    (``None`` where the sequence is whole). Off a mesh ``fn`` sees the
    whole cache."""
    mesh = mesh_of(q, k_c)
    if mesh is None:
        return fn(q, k, v, k_c, v_c, 0, None)
    from torch.distributed.tensor import DTensor, Shard
    names = mesh.mesh_dim_names
    cache_pl = (list(k_c.placements) if isinstance(k_c, DTensor)
                else placements(mesh, P()))
    on = {d: tuple(names[i] for i, pl in enumerate(cache_pl)
                   if isinstance(pl, Shard) and pl.dim == d) for d in (0, 2)}
    ba = on[0] if len(on[0]) > 1 else (on[0][0] if on[0] else None)
    seq = on[2][0] if on[2] else None
    part = k_c.shape[2] // axis_size(mesh, seq)
    lo = mesh.get_local_rank(seq) * part if seq else 0
    group = mesh.get_group(seq) if seq else None
    return run_local(lambda *a: fn(*a, lo, group), (q, k, v, k_c, v_c),
                     (P(ba),) * 3 + (cache_pl,) * 2, P(ba))


def _cached_attend(q, k, v, k_c, v_c, lo: int, group, *, start: int,
                   idx: int, window: int, cfg: ModelConfig,
                   gqa_mode: str) -> torch.Tensor:
    """One rank's part of cached attention (:func:`run_cached`): the new
    K/V positions that fall in its slots ``lo ..`` of the cache written
    in place, then its queries against its keys, merged over ``group``
    (sequence-parallel decode) where the cache's sequence is split."""
    s, part = q.shape[2], k_c.shape[2]
    a, b = max(start, lo), min(start + s, lo + part)
    if a < b:
        k_c[:, :, a - lo:b - lo] = k[:, :, a - start:b - start]
        v_c[:, :, a - lo:b - lo] = v[:, :, a - start:b - start]
    if group is None:
        return _sdpa(q, k_c, v_c, causal=True, window=window, q_offset=idx,
                     impl="plain", chunk=cfg.attn_chunk,
                     scores_f32=cfg.attn_scores_f32, gqa_mode=gqa_mode)
    return _sdpa_merged(q, k_c, v_c, idx, lo, window, cfg, group)


def _sdpa_merged(q, k, v, q_offset: int, key_offset: int, window: int,
                 cfg: ModelConfig, group) -> torch.Tensor:
    """Grouped-GQA causal attention of q against this rank's keys (global
    positions ``key_offset`` on), merged with the other ranks' of
    ``group`` (:func:`merged_softmax`), one query chunk at a time."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    acc_t = torch.float32 if cfg.attn_scores_f32 else q.dtype
    ki = key_offset + torch.arange(skv, device=q.device)[None, :]
    chunk = cfg.attn_chunk if 0 < cfg.attn_chunk < sq else sq
    outs = []
    for c0 in range(0, sq, chunk):
        qc = q[:, :, c0:c0 + chunk]
        cq = qc.shape[2]
        qg = qc.reshape(b, hkv, g, cq, d).to(acc_t)
        scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.to(acc_t)) \
            / math.sqrt(d)
        qi = (q_offset + c0 + torch.arange(cq, device=q.device))[:, None]
        mask = qi >= ki
        if window > 0:
            mask &= ki > qi - window
        scores = torch.where(mask, scores.float(), torch.full_like(
            scores, -1e30, dtype=torch.float32))
        out = merged_softmax(
            scores, lambda p: torch.einsum("bhgqk,bhkd->bhgqd", p, v),
            group, q.dtype)
        outs.append(out.reshape(b, hq, cq, d))
    return torch.cat(outs, dim=2)


def merged_softmax(scores: torch.Tensor, pv, group,
                   dtype: torch.dtype) -> torch.Tensor:
    """softmax(scores) V where each rank of ``group`` holds some of the
    keys: the running max and the softmax sums are all-reduced over the
    group; ``pv(p)`` multiplies this rank's unnormalised probabilities
    (in ``dtype``) by its values."""
    import torch.distributed._functional_collectives as funcol
    mx = funcol.all_reduce(scores.amax(-1, keepdim=True), "max", group)
    probs = torch.exp(scores - mx)
    den = funcol.all_reduce(probs.sum(-1, keepdim=True), "sum", group)
    num = funcol.all_reduce(pv(probs.to(dtype)).float(), "sum", group)
    return (num / den).to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device, d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_up = _param((d, f), cfg.pdtype, device)
        self.w_down = _param((f, d), cfg.pdtype, device)
        if cfg.activation == "swiglu":
            self.w_gate = _param((d, f), cfg.pdtype, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        d, f = self.w_up.shape
        _normal_(self.w_up, 1.0 / math.sqrt(d), generator)
        _normal_(self.w_down, 1.0 / math.sqrt(f), generator)
        if hasattr(self, "w_gate"):
            _normal_(self.w_gate, 1.0 / math.sqrt(d), generator)


def spec_mlp(cfg: ModelConfig) -> dict:
    sp = {"w_up": P("data", "model"), "w_down": P("model", "data")}
    if cfg.activation == "swiglu":
        sp["w_gate"] = P("data", "model")
    return sp


def mlp(p: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    up = col(x, p.w_up, cfg)
    if cfg.activation == "swiglu":
        act = F.silu(col(x, p.w_gate, cfg)) * up
    else:
        act = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return row(act, p.w_down, cfg)


# ---------------------------------------------------------------------------
# Mixture of Experts (grouped, sort-based capacity dispatch)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        self.router = _param((d, e), torch.float32, device)
        self.w_up = _param((e, d, f), cfg.pdtype, device)
        self.w_gate = _param((e, d, f), cfg.pdtype, device)
        self.w_down = _param((e, f, d), cfg.pdtype, device)
        if m.d_ff_shared:
            self.shared = MLP(cfg, device, d_ff=m.d_ff_shared)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        _, d, f = self.w_up.shape
        s = 1.0 / math.sqrt(d)
        for w in (self.router, self.w_up, self.w_gate):
            _normal_(w, s, generator)
        _normal_(self.w_down, 1.0 / math.sqrt(f), generator)
        if hasattr(self, "shared"):
            self.shared.init_params(generator)


def spec_moe(cfg: ModelConfig) -> dict:
    # expert parallelism when the expert count divides the model axis;
    # otherwise tensor-sharding each expert's matrices (e.g. Granite's 40
    # experts on a 16-wide axis)
    if cfg.moe.num_experts % 16 == 0:
        sp = {
            "router": P(None, None),
            "w_up": P("model", "data", None),
            "w_gate": P("model", "data", None),
            "w_down": P("model", None, "data"),
        }
    else:
        sp = {
            "router": P(None, None),
            "w_up": P(None, "data", "model"),
            "w_gate": P(None, "data", "model"),
            "w_down": P(None, "model", "data"),
        }
    if cfg.moe.d_ff_shared:
        sp["shared"] = spec_mlp(cfg)
    return sp


def moe_capacity(cfg: ModelConfig, tokens: int) -> Tuple[int, int, int]:
    """(groups G, tokens a group TL, slots an expert a group C) of the
    dispatch of ``tokens`` tokens, as the reference sizes them."""
    m = cfg.moe
    g = max(1, math.gcd(cfg.moe_groups, tokens))
    tl = tokens // g
    cap = int(math.ceil(tl * m.top_k / m.num_experts * m.capacity_factor))
    return g, tl, max(4, min(cap, tl))


def moe_route(p: MoE, xf: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The router of :func:`moe`: float32 softmax gates of xf (G, TL, D)
    over the experts, the top k of each token (descending, as
    ``lax.top_k``) renormalised to sum to 1. Returns (weights, experts),
    each (G, TL, k)."""
    gates = torch.softmax(xf.float() @ p.router, dim=-1)
    top_g, top_e = torch.topk(gates, cfg.moe.top_k, dim=-1)
    return top_g / top_g.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k token-choice MoE with the reference's grouped dispatch.

    The B*S tokens split into G groups (``moe_capacity``). Within a group
    the (token, choice) entries are sorted by expert (a stable sort, as
    ``jnp.argsort``: an expert's entries stay in token order), an entry's
    rank within its expert is its slot, and entries past the capacity C
    go to a spare row that is dropped. The experts run as batched
    products over a (G, E, C, D) buffer. The combine sums each token's
    gated expert outputs in the activation dtype in the order of their
    sorted positions, the order in which the reference's scatter-add
    visits them, and on the card in a fixed order (no atomics).

    On a mesh the groups lie on ``data`` and the dispatch and the combine
    run shard-local, as the reference's vmapped ones do. The experts run
    on ``model``: a whole expert a rank where the experts divide the
    model axis (expert parallelism: the group-to-expert reshard is the
    MoE all-to-all), else each expert's matrices split over it.
    """
    m = cfg.moe
    b, s, d = x.shape
    g, tl, cap = moe_capacity(cfg, b * s)
    mesh = mesh_of(x, p.router)
    if mesh is not None:
        # the groups on data (as the reference's constraint): a data
        # shard's tokens are whole groups when both divide it
        data = axis_size(mesh, "data")
        x = constrain(x, P("data" if g % data == 0 and b % data == 0
                           else None))
    xf = x.reshape(g, tl, d)
    if mesh is None:
        h, route = _moe_dispatch(xf, p.router, cfg, cap)
        out_e = _moe_experts(h, p.w_up, p.w_gate, p.w_down)
        y = _moe_combine(out_e, *route, cfg, tl)
    else:
        y = _moe_sharded(p, xf, cfg, cap, mesh)
    y = shard_batch(y.reshape(b, s, d), cfg)
    if m.d_ff_shared:
        y = y + mlp(p.shared, shard_batch(x, cfg), cfg)
    return y


def _moe_dispatch(xf, router, cfg: ModelConfig, cap: int):
    """Route xf (G, TL, D) and scatter its entries into the (G, E, C, D)
    expert buffer; returns it and the route (gates, order, slot, keep)."""
    g, tl, d = xf.shape
    k, e = cfg.moe.top_k, cfg.moe.num_experts
    adt, dev = cfg.adtype, xf.device
    top_g, top_e = moe_route(SimpleNamespace(router=router), xf, cfg)

    flat_e = top_e.reshape(g, tl * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)                          # sorted
    tok = order // k
    starts = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(tl * k, device=dev) - torch.gather(starts, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)            # spare row

    buf = torch.zeros((g, e * cap + 1, d), dtype=adt, device=dev)
    rows = torch.gather(xf, 1, tok[..., None].expand(g, tl * k, d))
    buf.scatter_(1, slot[..., None].expand(g, tl * k, d), rows.to(adt))
    h = buf[:, :e * cap].reshape(g, e, cap, d)
    return h, (top_g, order, slot, keep)


def _moe_experts(h, w_up, w_gate, w_down):
    up = torch.einsum("gecd,edf->gecf", h, w_up)
    gate = torch.einsum("gecd,edf->gecf", h, w_gate)
    return torch.einsum("gecf,efd->gecd", F.silu(gate) * up, w_down)


def _moe_combine(out_e, top_g, order, slot, keep, cfg: ModelConfig,
                 tl: int):
    """Each token's gated expert outputs, summed (G, TL, D)."""
    g, e, cap, d = out_e.shape
    k, adt, dev = cfg.moe.top_k, cfg.adtype, out_e.device
    flat = torch.cat([out_e.reshape(g, e * cap, d),
                      out_e.new_zeros((g, 1, d))], dim=1)
    weight = torch.gather(top_g.reshape(g, tl * k), 1, order).to(adt)
    picked = torch.gather(flat, 1, slot[..., None].expand(g, tl * k, d))
    picked = torch.where(keep[..., None], picked * weight[..., None],
                         torch.zeros((), dtype=adt, device=dev))
    # each token's k entries by sorted position (its experts in order)
    by_pos = torch.sort(torch.argsort(order, dim=-1).reshape(g, tl, k),
                        dim=-1).values
    y = torch.zeros((g, tl, d), dtype=adt, device=dev)
    for i in range(k):
        y = y + torch.gather(picked, 1,
                             by_pos[:, :, i, None].expand(g, tl, d))
    return y


def _moe_sharded(p: MoE, xf, cfg: ModelConfig, cap: int, mesh):
    g, tl, _ = xf.shape
    e, m = cfg.moe.num_experts, axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    grp = "data" if g % data == 0 and xf.shape[0] % data == 0 else None
    on_data = ("data",) if grp else ()
    gspec = P(grp, None, None)
    h, top_g, order, slot, keep = run_local(
        lambda xf, r: _flat_route(*_moe_dispatch(xf, r, cfg, cap)),
        (xf, p.router), (gspec, P(None, None)), (P(grp),) * 5,
        in_grads=(None, partial(mesh, P(None, None), on_data)))
    w_up, w_gate, w_down = fsdp(p.w_up), fsdp(p.w_gate), fsdp(p.w_down)
    if cfg.moe.num_experts % 16 == 0 and m > 1 and e % m == 0:
        # expert parallel: the buffer's experts move to their ranks
        hs, ws, wd = P(grp, "model"), P("model"), P("model")
        out, h_grad = hs, None
    else:
        f = "model" if m > 1 and w_up.shape[2] % m == 0 else None
        hs, ws, wd = P(grp), P(None, None, f), P(None, f)
        out = partial(mesh, P(grp), ("model",) if f else ())
        h_grad = partial(mesh, hs, ("model",) if f else ())
    w_grads = tuple(partial(mesh, s, on_data) for s in (ws, ws, wd))
    out_e = run_local(_moe_experts, (h, w_up, w_gate, w_down),
                      (hs, ws, ws, wd), out,
                      in_grads=(h_grad,) + w_grads)
    out_e = constrain(out_e, P(grp, None, None, None))
    return run_local(
        lambda oe, tg, o, sl, kp: _moe_combine(oe, tg, o, sl, kp, cfg, tl),
        (out_e, top_g, order, slot, keep), (P(grp),) * 5, P(grp))


def _flat_route(h, route):
    return (h,) + tuple(route)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma): a diagonal linear recurrence
# ---------------------------------------------------------------------------

class RGLRU(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.hybrid.lru_width or d
        self.w_x = _param((d, w), cfg.pdtype, device)
        self.w_gate_a = _param((d, w), cfg.pdtype, device)
        self.w_gate_x = _param((d, w), cfg.pdtype, device)
        self.w_out = _param((w, d), cfg.pdtype, device)
        self.lam = _param((w,), torch.float32, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        d, w = self.w_x.shape
        for p in (self.w_x, self.w_gate_a, self.w_gate_x):
            _normal_(p, 1.0 / math.sqrt(d), generator)
        _normal_(self.w_out, 1.0 / math.sqrt(w), generator)
        # Lambda, through softplus: a decay in (0, 1)
        _normal_(self.lam, 1.0, generator)
        self.lam.mul_(0.5).add_(4.0)


def spec_rglru(cfg: ModelConfig) -> dict:
    return {"w_x": P("data", "model"), "w_gate_a": P("data", "model"),
            "w_gate_x": P("data", "model"), "w_out": P("model", "data"),
            "lam": P("model")}


def _doubling_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log2(S)
    rounds of pair combines (see :func:`linear_scan`)."""
    a, h = a.clone(), b.clone()
    n, off = a.shape[1], 1
    while off < n:
        h_new = h.clone()
        h_new[:, off:] = h[:, :-off] * a[:, off:] + h[:, off:]
        a_new = a.clone()
        a_new[:, off:] = a[:, :-off] * a[:, off:]
        a, h = a_new, h_new
        off *= 2
    return h


class _LinearScan(torch.autograd.Function):
    """The doubling scan with the reverse recurrence as its backward:
    g_t = dL/dh_t + a_{t+1} g_{t+1} (zero past the end), dL/db_t = g_t,
    dL/da_t = g_t h_{t-1} (h_{-1} = 0), itself one doubling scan over the
    reversed sequence. It keeps a and h, two (B, S, W) tensors; autograd
    through the rounds would keep about 3 log2(S) of them (at
    RecurrentGemma's width 2,560, B 4 and S 2,048, ~84 MB each)."""

    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, grad_h):
        a, h = ctx.saved_tensors
        zero = a.new_zeros(a[:, :1].shape)
        a_next = torch.cat([a[:, 1:], zero], dim=1)
        g = _doubling_scan(a_next.flip(1), grad_h.flip(1)).flip(1)
        h_prev = torch.cat([zero, h[:, :-1]], dim=1)
        return g * h_prev, g


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: a log-depth
    doubling scan over the pairs (a, b), combining an earlier (a1, b1)
    with a later (a2, b2) into (a1 a2, b1 a2 + b2), as the reference's
    ``associative_scan`` does (in another tree, so float32 sums round
    in another order). Under autograd its backward is the reverse
    recurrence (:class:`_LinearScan`)."""
    return _LinearScan.apply(a, b)


def _scan(a: torch.Tensor, b: torch.Tensor, cfg: ModelConfig):
    """:func:`linear_scan`; on a mesh shard-local, the batch on the batch
    axes and the width on ``model`` (the recurrence runs along dim 1)."""
    mesh = mesh_of(a, b)
    if mesh is None:
        return linear_scan(a, b)
    ba = _batch_entry(cfg)
    if a.shape[0] % axis_size(mesh, ba):
        ba = None
    m = axis_size(mesh, "model")
    spec = P(ba, None, "model" if m > 1 and a.shape[2] % m == 0 else None)
    return run_local(linear_scan, (a, b), (spec, spec), spec)


def rglru(p: RGLRU, x: torch.Tensor, cfg: ModelConfig,
          state: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Real-gated LRU, h_t = a_t h_{t-1} + sqrt(1 - a_t^2)
    (i_t x_t), in float32; returns the output and h at the last position.

    Without a state and with S > 1 it scans (:func:`linear_scan`). With a
    state, or at S = 1, it applies the one-step formula h = a state + x
    to every position, as the reference does even when S > 1: each
    position then starts from ``state``, not from the position before.
    """
    xb = col(x, p.w_x, cfg)                                 # (B, S, W)
    ga = torch.sigmoid(col(x, p.w_gate_a, cfg).float())
    gx = torch.sigmoid(col(x, p.w_gate_x, cfg).float())
    neg_lam = -p.lam
    c = -8.0 * torch.logaddexp(neg_lam, torch.zeros_like(neg_lam))
    log_a = c[None, None, :] * ga                           # (B, S, W)
    a = torch.exp(log_a)
    gated_x = (xb.float() * gx) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    if state is None and x.shape[1] > 1:
        h = _scan(a, gated_x, cfg)
    else:
        st = state if state is not None else a.new_zeros(
            (x.shape[0], a.shape[-1]))
        h = a * st[:, None, :] + gated_x
    return row(h.to(x.dtype), p.w_out, cfg), h[:, -1]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N) of the mixer."""
    s_cfg = cfg.ssm
    d_in = s_cfg.expand * cfg.d_model
    nh = s_cfg.num_heads or d_in // s_cfg.head_dim
    return d_in, nh, d_in // nh, s_cfg.state_dim


class Mamba2Mixer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _, n = ssm_dims(cfg)
        self.w_in = _param((d, 2 * d_in + 2 * n + nh), cfg.pdtype, device)
        self.conv = _param((cfg.ssm.conv_width, d_in + 2 * n), cfg.pdtype,
                           device)
        self.a_log = _param((nh,), torch.float32, device)
        self.dt_bias = _param((nh,), torch.float32, device)
        self.d_skip = _param((nh,), torch.float32, device)
        self.norm = RMSNorm(d_in, cfg.pdtype, device)
        self.w_out = _param((d_in, d), cfg.pdtype, device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        d, d_in = self.w_in.shape[0], self.w_out.shape[0]
        _normal_(self.w_in, 1.0 / math.sqrt(d), generator)
        _normal_(self.conv, 0.3, generator)
        _normal_(self.w_out, 1.0 / math.sqrt(d_in), generator)
        self.a_log.fill_(-0.5)
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.norm.init_params(generator)


def spec_mamba2(cfg: ModelConfig) -> dict:
    return {"w_in": P("data", "model"), "conv": P(None, "model"),
            "a_log": P(None), "dt_bias": P(None), "d_skip": P(None),
            "norm": spec_rmsnorm(), "w_out": P("model", "data")}


def init_mamba2(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Mamba2Mixer:
    m = Mamba2Mixer(cfg, device)
    m.init_params(generator)
    return m


def _causal_conv(seq: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. seq: (B, S, C); w: (K, C). Returns the
    output and the last K - 1 inputs (the next call's state)."""
    k = w.shape[0]
    if state is None:
        pad = seq.new_zeros((seq.shape[0], k - 1, seq.shape[2]))
    else:
        pad = state.to(seq.dtype)
    full = torch.cat([pad, seq], dim=1)
    out = sum(full[:, i:i + seq.shape[1]] * w[i][None, None]
              for i in range(k))
    return out, full[:, -(k - 1):]


def mamba2(p: Mamba2Mixer, x: torch.Tensor, cfg: ModelConfig,
           state: Optional[Tuple] = None
           ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """SSD mixer. state = (h (B, NH, P, N) float32, conv_state).

    As in the reference, a call with a state and more than one position
    (a prefill into a cache) starts the SSD from a zero state and ignores
    ``state[0]``; the conv state is carried. Only a stateless call with
    ``attn_impl="kernel"`` runs the ``ssd_scan`` kernel.
    """
    zxbcdt = col(x, p.w_in, cfg)
    core = functools.partial(_mamba2_core, cfg=cfg,
                             has_state=state is not None)
    weights = (p.conv, p.dt_bias, p.a_log, p.d_skip)
    if state is None or mesh_of(zxbcdt, *state) is None:
        # on a mesh the core runs on DTensors as they come (the batch on
        # the batch axes), as the reference leaves it to its partitioner
        outs = core(zxbcdt, *weights, *(() if state is None else state))
    else:
        # serving: shard-local on the cache's batch layout (the states
        # gathered over model, written back by the caller)
        ba = _cache_batch(state[0])
        outs = run_local(core, (zxbcdt, *weights, *state),
                         (P(ba), P(None, None), P(None), P(None), P(None),
                          P(ba), P(ba)), (P(ba),) * 4)
    y, z = outs[0], outs[1]
    y = rms_norm(y, p.norm, cfg.norm_eps) * F.silu(z)
    out = row(y, p.w_out, cfg)
    new_state = None if state is None else (outs[2], outs[3])
    return out, new_state


def _mamba2_core(zxbcdt, conv_w, dt_bias, a_log, d_skip, *state,
                 cfg: ModelConfig, has_state: bool):
    """The mixer between its two projections: the causal conv, the SSD
    (``ssd_scan`` on the kernel path) and the skip; returns (y before
    the gated norm, z, and with a state the new h and conv state)."""
    b, s, _ = zxbcdt.shape
    d_in, nh, ph, n = ssm_dims(cfg)
    state = state if has_state else None
    z, xc, bmat, cmat, dt = torch.tensor_split(
        zxbcdt, [d_in, 2 * d_in, 2 * d_in + n, 2 * d_in + 2 * n], dim=-1)
    conv_in = torch.cat([xc, bmat, cmat], dim=-1)
    conv_state = None if state is None else state[1]
    conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_state)
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :d_in]
    bmat = conv_out[..., d_in:d_in + n]
    cmat = conv_out[..., d_in + n:]

    dt = dt.float() + dt_bias
    dt = torch.logaddexp(dt, torch.zeros_like(dt))      # softplus, (B,S,NH)
    a = -torch.exp(a_log)                                # (NH,)
    xh = xc.reshape(b, s, nh, ph)

    if state is None or s > 1:
        xf = xh.permute(0, 2, 1, 3).reshape(b * nh, s, ph).float()
        dtf = dt.permute(0, 2, 1).reshape(b * nh, s).contiguous()
        af = a.repeat(b)                     # jnp.tile: head h at i*nh + h
        bf = bmat[:, None].expand(b, nh, s, n).reshape(b * nh, s, n).float()
        cf = cmat[:, None].expand(b, nh, s, n).reshape(b * nh, s, n).float()
        if cfg.attn_impl == "kernel" and state is None:
            y = _ssd_kernel(xf.contiguous(), dtf, af, bf.contiguous(),
                            cf.contiguous(), cfg)
            new_h = None
        else:
            y, h_last = _ssd_xla(xf, dtf, af, bf, cf, cfg.ssm.chunk,
                                 return_state=True)
            new_h = (None if state is None
                     else h_last.reshape(b, nh, ph, n))
        y = y.reshape(b, nh, s, ph).permute(0, 2, 1, 3)
    else:
        h = state[0]                                     # (B, NH, P, N)
        dtb = dt[:, 0]                                   # (B, NH)
        decay = torch.exp(dtb * a[None])[:, :, None, None]
        upd = ((dtb[:, :, None] * xh[:, 0].float())[..., None]
               * bmat[:, 0].float()[:, None, None, :])
        h = h * decay + upd
        y = torch.einsum("bhpn,bn->bhp", h, cmat[:, 0].float())
        y = y.reshape(b, 1, nh, ph)
        new_h = h

    y = y + xh.float() * d_skip[None, None, :, None]
    y = y.reshape(b, s, d_in).to(zxbcdt.dtype)
    if state is None:
        return y, z
    return y, z, new_h, new_conv


def _ssd_kernel(x, dt, a, bmat, cmat, cfg: ModelConfig) -> torch.Tensor:
    """``kops.ssd_scan``; on a mesh each rank scans its own rows of the
    flattened batch x heads."""
    fn = functools.partial(kops.ssd_scan, chunk=cfg.ssm.chunk)
    mesh = mesh_of(x, dt, a, bmat, cmat)
    if mesh is None:
        return fn(x, dt, a, bmat, cmat)
    ba = _batch_entry(cfg)
    if x.shape[0] % axis_size(mesh, ba):
        ba = None
    return run_local(fn, (x, dt, a, bmat, cmat), (P(ba),) * 5, P(ba))


def _ssd_xla(x, dt, a, bmat, cmat, chunk: int, return_state: bool = False):
    """Chunked SSD in plain torch (the reference's ``_ssd_xla``: every
    chunk's intra part at once, then the carry over chunks).
    return_state=True also returns the final (BH, P, N) state."""
    bh, l, p = x.shape
    n = bmat.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(bh, nc, chunk, p)
    dtc = dt.reshape(bh, nc, chunk)
    bc = bmat.reshape(bh, nc, chunk, n)
    cc = cmat.reshape(bh, nc, chunk, n)
    seg = torch.cumsum(dtc * a[:, None, None], dim=-1)     # (BH,NC,C)
    scores = torch.einsum("bntk,bnuk->bntu", cc, bc)
    above = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=x.device).triu(1)
    # exp only on and below the diagonal, where the causal mask keeps a
    # value: above it the exponents are positive and can overflow, and
    # the reference's masking ``where`` then turns the gradient into NaN
    # (0 * inf). exp(-inf) = 0 masks those entries here instead
    lmat = (seg[..., :, None] - seg[..., None, :]).masked_fill_(
        above, -math.inf).exp_()
    w = scores * lmat * dtc[..., None, :]
    y_intra = torch.einsum("bntu,bnup->bntp", w, xc)

    # inter-chunk state carry (in order over chunks)
    decay_tail = torch.exp(seg[..., -1:] - seg)            # (BH,NC,C)
    xb = torch.einsum("bnc,bncp,bncq->bnpq", dtc * decay_tail, xc, bc)
    chunk_decay = torch.exp(seg[..., -1])                  # (BH,NC)
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=x.device)
    h_prev = []                                            # state BEFORE
    for i in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, i, None, None] + xb[:, i]
    h_prev = torch.stack(h_prev, dim=1)                    # (BH,NC,P,N)
    y_inter = torch.einsum("bntk,bnpk,bnt->bntp", cc, h_prev,
                           torch.exp(seg))
    y = (y_intra + y_inter).reshape(bh, nc * chunk, p)[:, :l]
    if return_state:
        return y, h
    return y
