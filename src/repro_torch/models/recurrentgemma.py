"""RecurrentGemma / Griffin hybrid (counterpart of
repro/models/recurrentgemma.py, arXiv:2402.19427): RG-LRU and local
sliding-window attention in a 2:1 pattern. Decode state is O(1): the
LRU states and a fixed window of K/V.

Layer = temporal-mixing block (RG-LRU or local attention) + MLP block,
pre-norm residuals. 26 layers = 8 groups of (rglru, rglru, local_attn)
+ 2 tail rglru layers. The embeddings are tied. The windowed attention
runs the plain path (the reference sends only window-free attention to
its kernel), so this model launches no kernel.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..launch.mesh import P
from . import layers as L
from .config import ModelConfig
from .stacking import stacked_specs, scan_layers


class RGLRULayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.mix = L.RGLRU(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.mlp = L.MLP(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.mix, self.ln2, self.mlp):
            m.init_params(generator)


class AttnLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.mlp = L.MLP(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init_params(generator)


class Group(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.r1 = RGLRULayer(cfg, device)
        self.r2 = RGLRULayer(cfg, device)
        self.a = AttnLayer(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.r1, self.r2, self.a):
            m.init_params(generator)


class RecurrentGemmaLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        pat = len(cfg.hybrid.pattern)           # 3
        self.n_groups = cfg.num_layers // pat
        self.n_tail = cfg.num_layers - self.n_groups * pat
        self.embed = L._param((cfg.padded_vocab, cfg.d_model), cfg.pdtype,
                              dev)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.pdtype, dev)
        self.groups = nn.ModuleList(Group(cfg, dev)
                                    for _ in range(self.n_groups))
        self.tail = nn.ModuleList(RGLRULayer(cfg, dev)
                                  for _ in range(self.n_tail))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "RecurrentGemmaLM":
        """Random weights at the reference's scales, drawn from
        ``generator`` (on the model's device)."""
        L._normal_(self.embed, 1.0, generator)
        self.ln_f.init_params(generator)
        for layer in (*self.groups, *self.tail):
            layer.init_params(generator)
        return self

    # ------------------------------------------------------------ blocks
    def param_specs(self) -> Dict:
        """The reference's partition specs of the stacked tree."""
        cfg = self.cfg
        r_spec = {"ln1": L.spec_rmsnorm(), "mix": L.spec_rglru(cfg),
                  "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp(cfg)}
        a_spec = {"ln1": L.spec_rmsnorm(), "attn": L.spec_attention(cfg),
                  "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp(cfg)}
        g_spec = {"r1": r_spec, "r2": r_spec, "a": a_spec}
        sp = {"embed": P("model", None), "ln_f": L.spec_rmsnorm(),
              "groups": stacked_specs(g_spec, len(self.groups))}
        if len(self.tail):
            sp["tail"] = stacked_specs(r_spec, len(self.tail))
        return sp

    def cache_specs(self) -> Dict:
        sp = {"index": P(),
              "groups": {"s1": P(None, "data", "model"),
                         "s2": P(None, "data", "model"),
                         "k": P(None, "data", None, "model", None),
                         "v": P(None, "data", None, "model", None)}}
        if len(self.tail):
            sp["tail"] = P(None, "data", "model")
        return sp

    def _rglru_layer(self, lp: RGLRULayer, x, state=None):
        cfg = self.cfg
        h, new_state = L.rglru(lp.mix, L.rms_norm(x, lp.ln1, cfg.norm_eps),
                               cfg, state)
        x = x + h
        x = x + L.mlp(lp.mlp, L.rms_norm(x, lp.ln2, cfg.norm_eps), cfg)
        return x, new_state

    def _mlp_tail(self, lp: AttnLayer, h):
        cfg = self.cfg
        return h + L.mlp(lp.mlp, L.rms_norm(h, lp.ln2, cfg.norm_eps), cfg)

    def _qkv(self, p: L.Attention, z, positions):
        """RoPE'd q (B, Hq, S, D) and k, v (B, Hkv, S, D) of ``z``."""
        cfg = self.cfg
        hq, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
        q = L._split_heads(L.col(z, p.wq, cfg), hq, hd)
        k = L._split_heads(L.col(z, p.wk, cfg), hkv, hd)
        v = L._split_heads(L.col(z, p.wv, cfg), hkv, hd)
        if cfg.qk_norm:
            q = L.rms_norm(q, p.q_norm, cfg.norm_eps)
            k = L.rms_norm(k, p.k_norm, cfg.norm_eps)
        q = L.rope(q.transpose(1, 2), positions,
                   cfg.rope_theta).transpose(1, 2)
        k = L.rope(k.transpose(1, 2), positions,
                   cfg.rope_theta).transpose(1, 2)
        return q, k, v

    def _positions(self, x, start=0):
        b, s, _ = x.shape
        return start + torch.arange(s, device=x.device)[None].expand(b, s)

    # ------------------------------------------------------------ forward
    def hidden(self, batch: Dict) -> torch.Tensor:
        """Final-norm hidden states (B, S, D)."""
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        x = L.shard_batch(x, cfg)
        positions = self._positions(x)

        def group_fn(lp: Group, h, e):
            h = L.shard_batch(h, cfg)
            h, _ = self._rglru_layer(lp.r1, h)
            h, _ = self._rglru_layer(lp.r2, h)
            z = L.rms_norm(h, lp.a.ln1, cfg.norm_eps)
            att, _ = L.attention(lp.a.attn, z, cfg, e,
                                 window=cfg.hybrid.window)
            return L.shard_batch(self._mlp_tail(lp.a, h + att), cfg)

        def tail_fn(lp: RGLRULayer, h, e):
            return L.shard_batch(self._rglru_layer(lp, h)[0], cfg)

        x = scan_layers(group_fn, self.groups, x, remat=cfg.remat,
                        carry_extra=positions)
        x = scan_layers(tail_fn, self.tail, x, remat=cfg.remat,
                        carry_extra=positions)
        return L.rms_norm(x, self.ln_f, cfg.norm_eps)

    def unembed(self) -> torch.Tensor:
        return self.embed.T

    def logits(self, batch: Dict) -> torch.Tensor:
        """(B, S, padded_vocab) float32 logits of a whole sequence."""
        return (self.hidden(batch)
                @ self.unembed().to(self.cfg.adtype)).float()

    forward = logits

    def _out(self, x) -> torch.Tensor:
        x = L.rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return (x[:, -1:] @ self.unembed().to(self.cfg.adtype)).float()

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """LRU states (float32) per group layer and tail layer, and a
        rolling window of min(window, max_seq) K/V slots per group."""
        cfg = self.cfg
        w = min(cfg.hybrid.window, max_seq)
        lru_w = cfg.hybrid.lru_width or cfg.d_model
        g, dev = self.n_groups, self.device
        kv = (g, batch, cfg.kv_heads, w, cfg.hd)
        state = dict(dtype=torch.float32, device=dev)
        cache = {
            "index": 0,
            "groups": {
                "s1": torch.zeros((g, batch, lru_w), **state),
                "s2": torch.zeros((g, batch, lru_w), **state),
                "k": torch.zeros(kv, dtype=cfg.adtype, device=dev),
                "v": torch.zeros(kv, dtype=cfg.adtype, device=dev),
            },
        }
        if self.n_tail:
            cache["tail"] = torch.zeros((self.n_tail, batch, lru_w),
                                        **state)
        return cache

    def _window_attention(self, lp: AttnLayer, h, positions, idx: int,
                          k_c, v_c):
        """Attention of the new positions against the rolling cache,
        written in place at slot = idx % window (the start clamped so the
        update fits, as ``dynamic_update_slice`` clamps); each slot's key
        position is recovered from the slot and masks the wrap-around."""
        cfg = self.cfg
        z = L.rms_norm(h, lp.ln1, cfg.norm_eps)
        q, k, v = self._qkv(lp.attn, z, positions)
        att = L.run_cached(functools.partial(_window_attend, cfg=cfg,
                                             idx=idx),
                           q, k, v, k_c, v_c, cfg)
        return h + L.row(L._merge_heads(att), lp.attn.wo, cfg)

    def forward_cached(self, cache: Dict,
                       batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Decode (or a short step) against the rolling cache, updated in
        place. Every RG-LRU layer takes its state, so with S > 1 each
        position steps from that state alone (the reference's
        :func:`~repro_torch.models.layers.rglru`)."""
        cfg = self.cfg
        idx = cache["index"]
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        positions = self._positions(x, idx)
        c = cache["groups"]
        for i, lp in enumerate(self.groups):
            x, s1 = self._rglru_layer(lp.r1, x, c["s1"][i])
            x, s2 = self._rglru_layer(lp.r2, x, c["s2"][i])
            x = self._window_attention(lp.a, x, positions, idx, c["k"][i],
                                       c["v"][i])
            x = self._mlp_tail(lp.a, x)
            c["s1"][i].copy_(s1)
            c["s2"][i].copy_(s2)
        new_cache = {"index": idx + x.shape[1], "groups": c}
        if self.n_tail:
            for i, lp in enumerate(self.tail):
                x, st = self._rglru_layer(lp, x, cache["tail"][i])
                cache["tail"][i].copy_(st)
            new_cache["tail"] = cache["tail"]
        return self._out(x), new_cache

    decode_step = forward_cached

    def prefill(self, cache: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Long prefill: the full-sequence forward (scanned LRU, windowed
        attention) from position 0, then the cache seeded with the final
        LRU states and the last min(S, window) keys and values at slot
        = pos % window. One position goes through ``forward_cached``."""
        cfg = self.cfg
        s = batch["tokens"].shape[1]
        if s <= 1:
            return self.forward_cached(cache, batch)
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        positions = self._positions(x)
        c = cache["groups"]
        w = c["k"].shape[3]
        for i, lp in enumerate(self.groups):
            x, s1 = self._rglru_layer(lp.r1, x)
            x, s2 = self._rglru_layer(lp.r2, x)
            z = L.rms_norm(x, lp.a.ln1, cfg.norm_eps)
            q, k, v = self._qkv(lp.a.attn, z, positions)
            att = L.sdpa(q, k, v, cfg, causal=True, window=cfg.hybrid.window)
            x = self._mlp_tail(lp.a, x + L.row(L._merge_heads(att),
                                               lp.a.attn.wo, cfg))
            c["s1"][i].copy_(s1)
            c["s2"][i].copy_(s2)
            if s >= w:
                c["k"][i].copy_(torch.roll(k[:, :, -w:], s % w, dims=2))
                c["v"][i].copy_(torch.roll(v[:, :, -w:], s % w, dims=2))
            else:
                # whole-slice copies (on a mesh the window's slots are
                # sharded; a copy lays the new values out as the cache)
                c["k"][i].copy_(torch.cat([k, c["k"][i][:, :, s:]], dim=2))
                c["v"][i].copy_(torch.cat([v, c["v"][i][:, :, s:]], dim=2))
        new_cache = {"index": cache["index"] + s, "groups": c}
        if self.n_tail:
            for i, lp in enumerate(self.tail):
                x, st = self._rglru_layer(lp, x)
                cache["tail"][i].copy_(st)
            new_cache["tail"] = cache["tail"]
        return self._out(x), new_cache


def _window_attend(q, k, v, k_c, v_c, lo: int, group, *,
                   cfg: ModelConfig, idx: int):
    """One rank's part of the rolling-window attention: q, k, v (B, H, S,
    D) of the new positions, its slots ``lo ..`` of the window cache
    (written in place where the new positions land, at slot = idx %
    window, the start clamped so the update fits, as
    ``dynamic_update_slice`` clamps); each slot's key position is
    recovered from the slot and masks the wrap-around; the new positions
    are idx on. With a ``group`` the ranks' partial softmax sums are
    merged over it."""
    hq, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    part, s = k_c.shape[2], q.shape[2]
    w = part * (1 if group is None else group.size())
    slot = idx % w
    start = min(slot, w - s)
    a, b = max(start, lo), min(start + s, lo + part)
    if a < b:
        k_c[:, :, a - lo:b - lo] = k[:, :, a - start:b - start]
        v_c[:, :, a - lo:b - lo] = v[:, :, a - start:b - start]
    slots = lo + torch.arange(part, device=q.device)
    key_pos = torch.where(slots <= slot, idx - slot + slots,
                          idx - slot + slots - w)
    rep = hq // hkv
    scores = (q.float() @ k_c.repeat_interleave(rep, 1).float()
              .transpose(-1, -2)) / math.sqrt(hd)
    qpos = idx + torch.arange(s, device=q.device)
    valid = (key_pos[None, None, None] >= 0) & \
        (key_pos[None, None, None] <= qpos[None, None, :, None])
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    if group is None:
        probs = torch.softmax(scores, -1).to(cfg.adtype)
        return probs @ v_c.repeat_interleave(rep, 1)
    return L.merged_softmax(scores,
                            lambda p: p @ v_c.repeat_interleave(rep, 1),
                            group, cfg.adtype)
