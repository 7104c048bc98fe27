"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060): attention-free
LM (counterpart of repro/models/mamba2.py). Decode carries an O(1)
(NH, P, N) state; the full-sequence forward runs the chunked SSD, through
the ``ssd_scan`` kernel when ``attn_impl="kernel"``."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig
from ..launch.mesh import P
from .stacking import scan_layers, scan_layers_with_cache, stacked_specs


class Mamba2Layer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, cfg.pdtype, device)
        self.mixer = L.Mamba2Mixer(cfg, device)

    def init_params(self, generator: torch.Generator) -> None:
        self.ln.init_params(generator)
        self.mixer.init_params(generator)


class Mamba2LM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        self.embed = L._param((cfg.padded_vocab, cfg.d_model), cfg.pdtype,
                              dev)
        self.ln_f = L.RMSNorm(cfg.d_model, cfg.pdtype, dev)
        self.layers = nn.ModuleList(Mamba2Layer(cfg, dev)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "Mamba2LM":
        """Random weights at the reference's scales, drawn from
        ``generator`` (on the model's device)."""
        L._normal_(self.embed, 1.0, generator)
        self.ln_f.init_params(generator)
        for layer in self.layers:
            layer.init_params(generator)
        return self

    def param_specs(self) -> Dict:
        """The reference's partition specs of the stacked tree."""
        cfg = self.cfg
        lspec = {"ln": L.spec_rmsnorm(), "mixer": L.spec_mamba2(cfg)}
        return {"embed": P("model", None), "ln_f": L.spec_rmsnorm(),
                "layers": stacked_specs(lspec, cfg.num_layers)}

    def cache_specs(self) -> Dict:
        return {"index": P(),
                "h": P(None, "data", "model", None, None),
                "conv": P(None, "data", None, "model")}

    def _block(self, lp: Mamba2Layer, h, _):
        h = L.shard_batch(h, self.cfg)
        y, _st = L.mamba2(lp.mixer, L.rms_norm(h, lp.ln, self.cfg.norm_eps),
                          self.cfg)
        return L.shard_batch(h + y, self.cfg)

    def hidden(self, batch: Dict) -> torch.Tensor:
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        x = L.shard_batch(x, cfg)
        x = scan_layers(self._block, self.layers, x, remat=cfg.remat)
        return L.rms_norm(x, self.ln_f, cfg.norm_eps)

    def unembed(self) -> torch.Tensor:
        return self.embed.T

    def logits(self, batch: Dict) -> torch.Tensor:
        """(B, S, padded_vocab) float32 logits of a whole sequence."""
        return (self.hidden(batch)
                @ self.unembed().to(self.cfg.adtype)).float()

    forward = logits

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_seq: int) -> Dict:
        cfg = self.cfg
        d_in, nh, ph, n = L.ssm_dims(cfg)
        conv_c = d_in + 2 * n
        nl = cfg.num_layers
        return {
            "index": 0,
            "h": torch.zeros((nl, batch, nh, ph, n), dtype=torch.float32,
                             device=self.device),
            "conv": torch.zeros((nl, batch, cfg.ssm.conv_width - 1, conv_c),
                                dtype=cfg.adtype, device=self.device),
        }

    def _block_cached(self, lp: Mamba2Layer, h, layer_cache, _):
        y, (new_h, new_conv) = L.mamba2(
            lp.mixer, L.rms_norm(h, lp.ln, self.cfg.norm_eps), self.cfg,
            state=(layer_cache["h"], layer_cache["conv"]))
        return h + y, {"h": new_h, "conv": new_conv}

    def forward_cached(self, cache: Dict,
                       batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """Shared prefill/decode: updates the cache's states in place and
        returns the last position's (B, 1, padded_vocab) float32 logits
        with the cache at its new index."""
        cfg = self.cfg
        x = L.embed(self.embed, batch["tokens"], cfg).to(cfg.adtype)
        states = {"h": cache["h"], "conv": cache["conv"]}
        x, states = scan_layers_with_cache(self._block_cached, self.layers,
                                           x, states)
        x = L.rms_norm(x, self.ln_f, cfg.norm_eps)
        logits = (x[:, -1:] @ self.unembed().to(cfg.adtype)).float()
        return logits, {"index": cache["index"] + batch["tokens"].shape[1],
                        **states}

    prefill = forward_cached
    decode_step = forward_cached
