"""End-to-end training example on the PyTorch/CUDA port (counterpart of
train_tinylm.py): train a smoke-scale LM with the full substrate —
synthetic data pipeline, AdamW + cosine schedule, checkpointing, the
fault-tolerant supervisor with an injected mid-run failure, and
straggler monitoring.

    PYTHONPATH=src python examples/torch_train_tinylm.py [--steps 200]
        [--arch tinyllama-1.1b] [--device cpu]

Without ``--device`` it trains on the CUDA card. Every arch trains: the
VLM's batches carry stub patches and Whisper's stub frames (fixed, from
a seed), which ``SyntheticTokens`` does not make.
"""
import argparse
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.runtime import StragglerMonitor, Supervisor
from repro_torch.train.step import init_train_state, make_train_step


def stub_inputs(cfg, batch, dev):
    """The inputs ``cfg``'s family takes beside its tokens, at the
    reference tests' 0.1 scale: VLM patches, Whisper frames."""
    g = torch.Generator().manual_seed(1)
    shapes = {"patches": cfg.vlm and (batch, cfg.vlm.num_patches,
                                      cfg.vlm.d_patch),
              "frames": cfg.encdec and (batch, cfg.encdec.encoder_seq,
                                        cfg.encdec.d_frame)}
    return {k: (0.1 * torch.randn(s, generator=g)).to(dev, cfg.adtype)
            for k, s in shapes.items() if s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", type=str, default="tinyllama_1_1b")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch).replace(ce_seq_chunk=32, moe_groups=2)
    model = build_model(cfg, dev)
    opt = adamw(cosine_schedule(3e-3, 20, args.steps))
    state = init_train_state(model, opt, torch.Generator(dev).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n_params / 1e6:.2f}M params (smoke config) on "
          f"{dev}")

    global_batch = 8
    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=global_batch, seed=0)
    extra = stub_inputs(cfg, global_batch, dev)
    train_step = make_train_step(model, opt, microbatches=2)

    def step_fn(st, b):
        out = train_step(st, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    fail_once = {args.steps // 2}

    def injector(step):
        if step in fail_once:
            fail_once.discard(step)
            return RuntimeError("injected failure (fault-tolerance demo)")
        return None

    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = Supervisor(
            step_fn=step_fn,
            batch_fn=lambda s: {**{k: torch.as_tensor(v, dtype=torch.int64,
                                                      device=dev)
                                   for k, v in ds.batch(s).items()},
                                **extra},
            ckpt=CheckpointManager(ckpt_dir, keep=2),
            # every 25 steps, as the reference; sooner on a short run, so
            # that the failure half way has a checkpoint to restore
            ckpt_every=max(1, min(25, args.steps // 4)),
            monitor=StragglerMonitor(n_hosts=4),
            failure_injector=injector)
        state = sup.run(state, start_step=0, num_steps=args.steps)
        sup.ckpt.wait()

    losses = [h["metrics"]["loss"] for h in sup.history
              if h["event"] == "step"]
    restarts = sum(1 for h in sup.history if h["event"] == "restart")
    print(f"steps run: {len(losses)} (incl. replay after {restarts} "
          f"restart)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    print("OK")


if __name__ == "__main__":
    main()
