"""Batched serving engine: prefill + greedy decode over request batches
(counterpart of repro/serve/engine.py).

Prompts are served ``batch_size`` at a time. Each batch is left-padded
with token 0 to its longest prompt, with no attention mask (pad tokens
are attended to and take positions, as in the reference), prefilled into
a fresh cache, then decoded greedily: the argmax runs over the padded
vocab, as the reference's does. A request stops at ``eos_id`` or after
``max_new_tokens``. ``extra_inputs`` (InternVL2's ``patches``,
Whisper's ``frames``) go to every batch's prefill, as in the reference.
The model runs on the device its parameters are on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, batch_size: int, max_seq: int,
                 eos_id: int = 2):
        self.model = model
        self.batch = batch_size
        self.max_seq = max_seq
        self.eos_id = eos_id

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: int = 16,
                 extra_inputs: Optional[Dict] = None) -> List[List[int]]:
        """Greedy-decode a list of prompts (``batch_size`` per batch)."""
        out: List[List[int]] = []
        for i in range(0, len(prompts), self.batch):
            chunk = prompts[i:i + self.batch]
            out.extend(self._generate_batch(chunk, max_new_tokens,
                                            extra_inputs))
        return out

    def _generate_batch(self, prompts, max_new_tokens, extra_inputs):
        dev = self.model.device
        b = len(prompts)
        pad_b = self.batch
        plen = max(len(p) for p in prompts)
        tokens = np.zeros((pad_b, plen), np.int64)
        for j, p in enumerate(prompts):
            tokens[j, plen - len(p):] = p          # left-pad
        cache = self.model.init_cache(pad_b, self.max_seq)
        batch = {"tokens": torch.as_tensor(tokens, device=dev)}
        if extra_inputs:
            batch.update({k: torch.as_tensor(v, device=dev)
                          for k, v in extra_inputs.items()})
        logits, cache = self.model.prefill(cache, batch)
        results = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        cur = torch.argmax(logits[:, -1], -1).cpu().numpy()
        for _ in range(max_new_tokens):
            for j in range(b):
                if not done[j]:
                    results[j].append(int(cur[j]))
                    if cur[j] == self.eos_id:
                        done[j] = True
            if done.all():
                break
            step = np.pad(cur, (0, pad_b - len(cur)))[:, None]
            logits, cache = self.model.decode_step(
                cache, {"tokens": torch.as_tensor(step, dtype=torch.int64,
                                                  device=dev)})
            cur = torch.argmax(logits[:, -1], -1).cpu().numpy()
        return results
