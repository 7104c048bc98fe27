"""Decoder-only transformer LM (counterpart of
repro/models/transformer.py) for the dense, MoE and VLM families
(TinyLlama, Phi-3, DeepSeek-Coder, Qwen3, Kimi K2, Granite, InternVL2):
pre-norm blocks, GQA attention (+ optional qk-norm), SwiGLU MLP or top-k
MoE, RoPE; optional leading dense layers before the MoE layers (Kimi
style, ``moe.first_k_dense``) and an optional vision-patch prefix
(InternVL's stub frontend: precomputed patch embeddings under
``batch["patches"]``, projected by ``patch_proj`` and put before the
text; their positions are dropped from the hidden states).

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
from ..launch.mesh import P
from .stacking import scan_layers, scan_layers_with_cache, stacked_specs


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


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.moe = L.MoE(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.moe):
            m.init_params(generator)


class TransformerLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        m = cfg.moe
        self.n_dense = (cfg.num_layers if m is None or m.num_experts == 0
                        else m.first_k_dense)
        self.n_moe = cfg.num_layers - self.n_dense
        self.embed = L._param((cfg.padded_vocab, cfg.d_model), cfg.pdtype,
                              dev)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.pdtype, dev)
        if not cfg.tie_embeddings:
            self.unembed_w = L._param((cfg.d_model, cfg.padded_vocab),
                                      cfg.pdtype, dev)
        self.dense_layers = nn.ModuleList(
            DenseBlock(cfg, dev) for _ in range(self.n_dense))
        self.moe_layers = nn.ModuleList(
            MoEBlock(cfg, dev) for _ in range(self.n_moe))
        if cfg.vlm is not None:
            self.patch_proj = L._param((cfg.vlm.d_patch, cfg.d_model),
                                       cfg.pdtype, dev)

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
        for layer in (*self.dense_layers, *self.moe_layers):
            layer.init_params(generator)
        if cfg.vlm is not None:
            L._normal_(self.patch_proj, 1.0 / cfg.vlm.d_patch ** 0.5,
                       generator)
        return self

    def param_specs(self) -> Dict:
        """The reference's partition specs of the stacked tree."""
        cfg = self.cfg
        dense_spec = {
            "ln1": L.spec_rmsnorm(), "attn": L.spec_attention(cfg),
            "ln2": L.spec_rmsnorm(), "mlp": L.spec_mlp(cfg),
        }
        sp = {
            "embed": P("model", None),
            "ln_f": L.spec_rmsnorm(),
        }
        if not cfg.tie_embeddings:
            sp["unembed"] = P(None, "model")
        if self.n_dense:
            sp["dense_layers"] = stacked_specs(dense_spec, self.n_dense)
        if self.n_moe:
            moe_spec = {
                "ln1": L.spec_rmsnorm(), "attn": L.spec_attention(cfg),
                "ln2": L.spec_rmsnorm(), "moe": L.spec_moe(cfg),
            }
            sp["moe_layers"] = stacked_specs(moe_spec, self.n_moe)
        if cfg.vlm is not None:
            sp["patch_proj"] = P(None, None)
        return sp

    def _groups(self):
        """The layer groups in order: (cache key, layers)."""
        return [(key, layers) for key, layers in (("dense",
                                                   self.dense_layers),
                                                  ("moe", self.moe_layers))
                if len(layers)]

    # ------------------------------------------------------------ forward
    def _ffn(self, lp, z):
        if isinstance(lp, MoEBlock):
            return L.moe(lp.moe, z, self.cfg)
        return L.mlp(lp.mlp, z, self.cfg)

    def _block(self, lp, x, positions):
        cfg = self.cfg
        x = L.shard_batch(x, cfg)
        h, _ = L.attention(lp.attn, L.rms_norm(x, lp.ln1, cfg.norm_eps),
                           cfg, positions)
        x = x + h
        x = x + self._ffn(lp, L.rms_norm(x, lp.ln2, cfg.norm_eps))
        return L.shard_batch(x, cfg)

    def _inputs(self, batch) -> torch.Tensor:
        """Token embeddings, after the projected patches when the model
        has a vision prefix and the batch brings ``patches``."""
        adt = self.cfg.adtype
        x = L.embed(self.embed, batch["tokens"], self.cfg).to(adt)
        if self.cfg.vlm is not None and "patches" in batch:
            vis = L.shard_batch(L.col(batch["patches"].to(adt),
                                      self.patch_proj.to(adt), self.cfg),
                                self.cfg)
            x = torch.cat([vis, x], dim=1)
        return x

    def _embed(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._inputs(batch)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        return x, positions

    def hidden(self, batch: Dict) -> torch.Tensor:
        """Final-norm hidden states (B, S_tokens, D): patch positions are
        dropped."""
        cfg = self.cfg
        x, positions = self._embed(batch)
        x = L.shard_batch(x, cfg)
        for _, layers in self._groups():
            x = scan_layers(self._block, layers, x, remat=cfg.remat,
                            carry_extra=positions)
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        if cfg.vlm is not None and "patches" in batch:
            x = x[:, -batch["tokens"].shape[1]:]
        return x

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
        """K/V caches (L, B, Hkv, max_seq, D) per layer group; the index
        is a Python int."""
        cfg = self.cfg
        zeros = dict(dtype=cfg.adtype, device=self.device)
        cache = {"index": 0}
        for key, layers in self._groups():
            shape = (len(layers), batch, cfg.kv_heads, max_seq, cfg.hd)
            cache[key] = {"k": torch.zeros(shape, **zeros),
                          "v": torch.zeros(shape, **zeros)}
        return cache

    def cache_specs(self) -> Dict:
        """The reference's partition specs of the cache. "seq": batch on
        data, the sequence on model (kv-head counts of 4 or 8 do not
        divide a 16-wide model axis; the cache length does); "batch":
        replicated over model."""
        if self.cfg.kv_cache_shard == "seq":
            kv = {"k": P(None, "data", None, "model", None),
                  "v": P(None, "data", None, "model", None)}
        else:
            kv = {"k": P(None, "data", None, None, None),
                  "v": P(None, "data", None, None, None)}
        sp = {"index": P()}
        for key, _ in self._groups():
            sp[key] = dict(kv)
        return sp

    def _block_cached(self, lp, x, layer_cache, extra):
        cfg = self.cfg
        positions, idx = extra
        h, (k_c, v_c, _) = L.attention(
            lp.attn, L.rms_norm(x, lp.ln1, cfg.norm_eps), cfg, positions,
            cache=(layer_cache["k"], layer_cache["v"], idx))
        x = x + h
        x = x + self._ffn(lp, L.rms_norm(x, lp.ln2, cfg.norm_eps))
        return x, {"k": k_c, "v": v_c}

    def forward_cached(self, cache: Dict,
                       batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Shared prefill/decode: consumes tokens (after the projected
        patches, when the batch brings them) at positions
        ``cache["index"]`` on, appends their K/V to the cache (in place)
        and returns the last position's (B, 1, padded_vocab) float32
        logits with the cache at its new index."""
        cfg = self.cfg
        idx = cache["index"]
        x = self._inputs(batch)
        b, s, _ = x.shape
        positions = idx + torch.arange(s, device=x.device)[None].expand(b, s)
        new_cache = {"index": idx + s}
        for key, layers in self._groups():
            x, new_cache[key] = scan_layers_with_cache(
                self._block_cached, layers, x, cache[key],
                carry_extra=(positions, idx))
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        logits = (x[:, -1:] @ self.unembed().to(cfg.adtype)).float()
        return logits, new_cache

    prefill = forward_cached
    decode_step = forward_cached
