"""Decoder-only transformer LM (counterpart of
repro/models/transformer.py), ported for the dense family (TinyLlama):
pre-norm blocks, GQA attention (+ optional qk-norm), SwiGLU MLP, RoPE.
The MoE and VLM variants come with the slice that ports their models
and raise here.

Parameters live in the module (``init_params(generator)`` draws them;
``interop.lm_params_from_numpy`` carries the reference's in), so the
forward methods take the batch only: ``logits(batch)`` for a whole
sequence, ``forward_cached(cache, batch)`` (= ``prefill`` =
``decode_step``) for serving. The untied output matrix is the
``unembed_w`` parameter (the reference's ``unembed`` key), since
``unembed()`` is the method that returns it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig
from .stacking import scan_layers, scan_layers_with_cache


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.mlp = L.MLP(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init_params(generator)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.family != "dense" or (cfg.moe is not None
                                     and cfg.moe.num_experts) or cfg.vlm:
            raise NotImplementedError(
                f"TransformerLM family {cfg.family!r} (MoE/VLM) is not "
                f"ported yet: it comes with the remaining-models slice")
        self.cfg = cfg
        dev = resolve_device(device)
        self.n_dense = cfg.num_layers
        self.embed = L._param((cfg.padded_vocab, cfg.d_model), cfg.pdtype,
                              dev)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.pdtype, dev)
        if not cfg.tie_embeddings:
            self.unembed_w = L._param((cfg.d_model, cfg.padded_vocab),
                                      cfg.pdtype, dev)
        self.dense_layers = nn.ModuleList(
            DenseBlock(cfg, dev) for _ in range(self.n_dense))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------ params
    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "TransformerLM":
        """Random weights at the reference's scales, drawn from
        ``generator`` (on the model's device)."""
        cfg = self.cfg
        L._normal_(self.embed, 1.0, generator)
        self.ln_f.init_params(generator)
        if not cfg.tie_embeddings:
            L._normal_(self.unembed_w, 1.0 / cfg.d_model ** 0.5, generator)
        for layer in self.dense_layers:
            layer.init_params(generator)
        return self

    # ------------------------------------------------------------ forward
    def _block(self, lp: DenseBlock, x, positions):
        cfg = self.cfg
        h, _ = L.attention(lp.attn, L.rms_norm(x, lp.ln1, cfg.norm_eps),
                           cfg, positions)
        x = x + h
        z = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        return x + L.mlp(lp.mlp, z, cfg)

    def _embed(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.embed[batch["tokens"]].to(self.cfg.adtype)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def hidden(self, batch: Dict) -> torch.Tensor:
        """Final-norm hidden states (B, S, D)."""
        cfg = self.cfg
        x, positions = self._embed(batch)
        x = scan_layers(self._block, self.dense_layers, x,
                        remat=cfg.remat, carry_extra=positions)
        return L.rms_norm(x, self.ln_f, cfg.norm_eps)

    def unembed(self) -> torch.Tensor:
        return (self.embed.T if self.cfg.tie_embeddings
                else self.unembed_w)

    def logits(self, batch: Dict) -> torch.Tensor:
        """(B, S, padded_vocab) float32 logits of a whole sequence."""
        return (self.hidden(batch)
                @ self.unembed().to(self.cfg.adtype)).float()

    forward = logits

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        cfg = self.cfg
        shape = (self.n_dense, batch, cfg.kv_heads, max_seq, cfg.hd)
        zeros = dict(dtype=cfg.adtype, device=self.device)
        return {"index": 0,
                "dense": {"k": torch.zeros(shape, **zeros),
                          "v": torch.zeros(shape, **zeros)}}

    def _block_cached(self, lp: DenseBlock, x, layer_cache, extra):
        cfg = self.cfg
        positions, idx = extra
        h, (k_c, v_c, _) = L.attention(
            lp.attn, L.rms_norm(x, lp.ln1, cfg.norm_eps), cfg, positions,
            cache=(layer_cache["k"], layer_cache["v"], idx))
        x = x + h
        z = L.rms_norm(x, lp.ln2, cfg.norm_eps)
        return x + L.mlp(lp.mlp, z, cfg), {"k": k_c, "v": v_c}

    def forward_cached(self, cache: Dict,
                       batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Shared prefill/decode: consumes tokens at positions
        ``cache["index"]`` on, appends their K/V to the cache (in place)
        and returns the last position's (B, 1, padded_vocab) float32
        logits with the cache at its new index."""
        cfg = self.cfg
        idx = cache["index"]
        x = self.embed[batch["tokens"]].to(cfg.adtype)
        b, s, _ = x.shape
        positions = idx + torch.arange(s, device=x.device)[None].expand(b, s)
        x, kv = scan_layers_with_cache(self._block_cached,
                                       self.dense_layers, x, cache["dense"],
                                       carry_extra=(positions, idx))
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        logits = (x[:, -1:] @ self.unembed().to(cfg.adtype)).float()
        return logits, {"index": idx + s, "dense": kv}

    prefill = forward_cached
    decode_step = forward_cached
