"""Serving example on the PyTorch/CUDA port (counterpart of
serve_lm.py): batched greedy decoding with the slot-based engine
(prefill + KV-cache decode), on a smoke-scale model with random weights
from a seed.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
        [--arch tinyllama-1.1b]

Without ``--device`` it runs on the CUDA card. InternVL2 serves with
stub patches and Whisper with stub frames (``extra_inputs``).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--arch", type=str, default="tinyllama-1.1b")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    model = build_model(cfg, dev)
    model.init_params(torch.Generator(dev).manual_seed(0))
    batch_size = 4
    engine = ServeEngine(model, batch_size=batch_size, max_seq=96)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size - 1, size=n)
               .astype(np.int32) for n in (5, 9, 7, 3, 6)]
    extra = {}
    if cfg.vlm is not None:
        extra["patches"] = 0.1 * torch.randn(
            (batch_size, cfg.vlm.num_patches, cfg.vlm.d_patch),
            generator=torch.Generator().manual_seed(1)).to(dev, cfg.adtype)
    if cfg.encdec is not None:
        extra["frames"] = 0.1 * torch.randn(
            (batch_size, cfg.encdec.encoder_seq, cfg.encdec.d_frame),
            generator=torch.Generator().manual_seed(1)).to(dev, cfg.adtype)
    with torch.inference_mode():
        outs = engine.generate(prompts, max_new_tokens=12,
                               extra_inputs=extra or None)
        for i, (p, o) in enumerate(zip(prompts, outs)):
            print(f"req{i}: prompt={list(p)} -> generated={o}")
        assert all(len(o) >= 1 for o in outs)
        # determinism: same batch -> same greedy outputs
        again = engine.generate(prompts, max_new_tokens=12,
                                extra_inputs=extra or None)
    assert again == outs, "greedy decode must be deterministic"
    print("OK")


if __name__ == "__main__":
    main()
