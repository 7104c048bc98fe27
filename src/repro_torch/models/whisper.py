"""Whisper-medium encoder-decoder (counterpart of repro/models/whisper.py,
arXiv:2212.04356). The conv frontend is a stub, as in the reference:
the batch brings precomputed frame embeddings ``frames`` (B, 1500,
d_frame) and a linear projection stands in for the two conv layers.
Pre-LN LayerNorm (with bias), GELU MLPs, multi-head attention without
RoPE (learned positions). Every attention runs the plain path, as the
reference's does, so this model launches no kernel.

``max_seq`` is the decoder's self-attention length; the encoder length
is ``encdec.encoder_seq``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..launch.mesh import P
from . import layers as L
from .config import ModelConfig
from .stacking import scan_layers, stacked_specs


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.LayerNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.LayerNorm(cfg.d_model, cfg.pdtype, device)
        self.mlp = L.MLP(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init_params(generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.LayerNorm(cfg.d_model, cfg.pdtype, device)
        self.self_attn = L.Attention(cfg, device)
        self.ln_x = L.LayerNorm(cfg.d_model, cfg.pdtype, device)
        self.cross_attn = L.Attention(cfg, device)
        self.ln2 = L.LayerNorm(cfg.d_model, cfg.pdtype, device)
        self.mlp = L.MLP(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.self_attn, self.ln_x, self.cross_attn,
                  self.ln2, self.mlp):
            m.init_params(generator)


class WhisperEncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        e, d = cfg.encdec, cfg.d_model
        self.frame_proj = L._param((e.d_frame, d), cfg.pdtype, dev)
        self.enc_pos = L._param((e.encoder_seq, d), cfg.pdtype, dev)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, dev)
                                        for _ in range(e.encoder_layers))
        self.ln_enc = L.LayerNorm(d, cfg.pdtype, dev)
        self.embed = L._param((cfg.padded_vocab, d), cfg.pdtype, dev)
        self.dec_pos = L._param((cfg.max_seq, d), cfg.pdtype, dev)
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, dev)
                                        for _ in range(cfg.num_layers))
        self.ln_f = L.LayerNorm(d, cfg.pdtype, dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "WhisperEncDec":
        """Random weights at the reference's scales, drawn from
        ``generator`` (on the model's device)."""
        L._normal_(self.frame_proj, 1.0 / self.cfg.encdec.d_frame ** 0.5,
                   generator)
        L._normal_(self.enc_pos, 0.02, generator)
        for layer in self.enc_layers:
            layer.init_params(generator)
        self.ln_enc.init_params(generator)
        L._normal_(self.embed, 1.0, generator)
        L._normal_(self.dec_pos, 0.02, generator)
        for layer in self.dec_layers:
            layer.init_params(generator)
        self.ln_f.init_params(generator)
        return self

    def param_specs(self) -> Dict:
        """The reference's partition specs of the stacked tree."""
        cfg = self.cfg
        enc_spec = {"ln1": L.spec_layernorm(),
                    "attn": L.spec_attention(cfg),
                    "ln2": L.spec_layernorm(), "mlp": L.spec_mlp(cfg)}
        dec_spec = {"ln1": L.spec_layernorm(),
                    "self_attn": L.spec_attention(cfg),
                    "ln_x": L.spec_layernorm(),
                    "cross_attn": L.spec_attention(cfg),
                    "ln2": L.spec_layernorm(), "mlp": L.spec_mlp(cfg)}
        return {
            "frame_proj": P(None, "model"),
            "enc_pos": P(None, None),
            "enc_layers": stacked_specs(enc_spec, cfg.encdec.encoder_layers),
            "ln_enc": L.spec_layernorm(),
            "embed": P("model", None),
            "dec_pos": P(None, None),
            "dec_layers": stacked_specs(dec_spec, cfg.num_layers),
            "ln_f": L.spec_layernorm(),
        }

    def cache_specs(self) -> Dict:
        kv = P(None, "data", "model", None, None)
        return {"index": P(), "k": kv, "v": kv, "xk": kv, "xv": kv}

    # ------------------------------------------------------------ encoder
    def _attend(self, p: L.Attention, x, src, causal: bool,
                q_offset: int = 0, kv: Optional[Tuple] = None):
        """Attention of ``x`` over ``src`` (or over the given K/V), no
        RoPE, on the plain path."""
        cfg = self.cfg
        hq, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
        q = L._split_heads(L.col(x, p.wq, cfg), hq, hd)
        if kv is None:
            kv = (L._split_heads(L.col(src, p.wk, cfg), hkv, hd),
                  L._split_heads(L.col(src, p.wv, cfg), hkv, hd))
        if q_offset:
            out = L._sdpa(q, *kv, causal=causal, window=0,
                          q_offset=q_offset)
        else:
            out = L.sdpa(q, *kv, cfg, causal=causal)
        return L.row(L._merge_heads(out), p.wo, cfg)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Encoder states (B, frames, D) of ``frames`` (B, frames,
        d_frame): projection, learned positions, bidirectional layers."""
        cfg = self.cfg
        x = L.shard_batch(L.col(frames.to(cfg.adtype), self.frame_proj,
                                cfg), cfg)
        x = x + self.enc_pos[None, :x.shape[1]].to(cfg.adtype)

        def block(lp: EncoderLayer, h, _):
            h = L.shard_batch(h, cfg)
            z = L.layer_norm(h, lp.ln1)
            h = h + self._attend(lp.attn, z, z, causal=False)
            return L.shard_batch(
                h + L.mlp(lp.mlp, L.layer_norm(h, lp.ln2), cfg), cfg)

        x = scan_layers(block, self.enc_layers, x, remat=cfg.remat)
        return L.layer_norm(x, self.ln_enc)

    def _decoder_layer(self, lp: DecoderLayer, h, enc):
        cfg = self.cfg
        h = L.shard_batch(h, cfg)
        z = L.layer_norm(h, lp.ln1)
        h = h + self._attend(lp.self_attn, z, z, causal=True)
        zx = L.layer_norm(h, lp.ln_x)
        h = h + self._attend(lp.cross_attn, zx, enc, causal=False)
        return L.shard_batch(
            h + L.mlp(lp.mlp, L.layer_norm(h, lp.ln2), cfg), cfg)

    # ------------------------------------------------------------ forward
    def hidden(self, batch: Dict) -> torch.Tensor:
        """Final-norm decoder states (B, S, D) of ``tokens`` over the
        encoded ``frames``."""
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        x = x + self.dec_pos[None, :x.shape[1]].to(cfg.adtype)
        x = L.shard_batch(x, cfg)
        x = scan_layers(self._decoder_layer, self.dec_layers, x,
                        remat=cfg.remat, carry_extra=enc)
        return L.layer_norm(x, self.ln_f)

    def unembed(self) -> torch.Tensor:
        return self.embed.T

    def logits(self, batch: Dict) -> torch.Tensor:
        """(B, S, padded_vocab) float32 logits of a whole sequence."""
        return (self.hidden(batch)
                @ self.unembed().to(self.cfg.adtype)).float()

    forward = logits

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        """Self-attention K/V (L, B, Hkv, max_seq, D) and cross-attention
        K/V (L, B, Hkv, encoder_seq, D), which ``prefill`` fills once."""
        cfg = self.cfg
        n = cfg.num_layers
        kv = (n, batch, cfg.kv_heads, max_seq, cfg.hd)
        xkv = (n, batch, cfg.kv_heads, cfg.encdec.encoder_seq, cfg.hd)
        zeros = dict(dtype=cfg.adtype, device=self.device)
        return {"index": 0,
                "k": torch.zeros(kv, **zeros), "v": torch.zeros(kv, **zeros),
                "xk": torch.zeros(xkv, **zeros),
                "xv": torch.zeros(xkv, **zeros)}

    def prefill(self, cache: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Encode the ``frames``, compute every layer's cross K/V once
        (they take the encoder's length), then run the decoder tokens."""
        cfg = self.cfg
        enc = self.encode(batch["frames"])
        hkv, hd = cfg.kv_heads, cfg.hd
        cache = dict(cache)
        cache["xk"] = torch.stack([
            L._split_heads(enc @ lp.cross_attn.wk, hkv, hd)
            for lp in self.dec_layers])
        cache["xv"] = torch.stack([
            L._split_heads(enc @ lp.cross_attn.wv, hkv, hd)
            for lp in self.dec_layers])
        return self.decode_step(cache, batch)

    def decode_step(self, cache: Dict,
                    batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Decoder tokens at positions ``cache["index"]`` on: their K/V
        written into the cache in place (the start clamped so they fit,
        as ``dynamic_update_slice`` clamps), ``dec_pos`` taken at the
        unclamped positions; returns the last position's float32
        logits. A position past ``max_seq`` reads a NaN row of
        ``dec_pos``, as the reference's ``jnp.take`` fills it."""
        cfg = self.cfg
        idx = cache["index"]
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        s = x.shape[1]
        pos_ids = idx + torch.arange(s, device=x.device)
        n_pos = self.dec_pos.shape[0]
        rows = self.dec_pos[pos_ids.clamp(max=n_pos - 1)]
        rows = torch.where((pos_ids < n_pos)[:, None], rows,
                           torch.full_like(rows, float("nan")))
        x = x + rows[None].to(cfg.adtype)
        hkv, hd = cfg.kv_heads, cfg.hd
        s_max = cache["k"].shape[3]
        start = min(max(idx, 0), s_max - s)
        for i, lp in enumerate(self.dec_layers):
            z = L.layer_norm(x, lp.ln1)
            k_c, v_c = cache["k"][i], cache["v"][i]
            k_c[:, :, start:start + s] = L._split_heads(
                z @ lp.self_attn.wk, hkv, hd)
            v_c[:, :, start:start + s] = L._split_heads(
                z @ lp.self_attn.wv, hkv, hd)
            x = x + self._attend(lp.self_attn, z, None, causal=True,
                                 q_offset=idx, kv=(k_c, v_c))
            zx = L.layer_norm(x, lp.ln_x)
            x = x + self._attend(lp.cross_attn, zx, None, causal=False,
                                 kv=(cache["xk"][i], cache["xv"][i]))
            x = x + L.mlp(lp.mlp, L.layer_norm(x, lp.ln2), cfg)
        x = L.layer_norm(x, self.ln_f)
        logits = (x[:, -1:] @ self.unembed().to(cfg.adtype)).float()
        return logits, {**cache, "index": idx + s}
