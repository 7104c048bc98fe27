"""Serving launcher: batched greedy decode with the slot engine
(counterpart of repro/launch/serve.py).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --requests 8 --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded 0; the
prompts are drawn as in the reference (numpy, seed 0, lengths 3-11).
``--device`` is the port's own flag: without it the model runs on the
CUDA card. Every arch is taken, and like the reference's launcher this
one passes no patches and no frames: InternVL2 serves text alone, and
Whisper, whose prefill needs ``frames``, raises ``KeyError`` in both
(serve it through :class:`~repro_torch.serve.ServeEngine` with
``extra_inputs``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def make_prompts(vocab_size: int, n: int, seed: int = 0):
    """``n`` prompts of 3-11 tokens in [3, vocab_size - 1), as the
    reference's launcher draws them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab_size - 1, size=int(rng.integers(3, 12)))
            .astype(np.int32) for _ in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = build_model(cfg, dev).init_params(
        torch.Generator(dev).manual_seed(0))
    engine = ServeEngine(model, batch_size=args.batch, max_seq=args.max_seq)

    prompts = make_prompts(cfg.vocab_size, args.requests)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"[serve] {args.requests} requests, {n_tok} tokens in "
          f"{dt:.2f}s ({n_tok / dt:.1f} tok/s on {dev.type})")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o}")


if __name__ == "__main__":
    main()
