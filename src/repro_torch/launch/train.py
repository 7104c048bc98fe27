"""Training launcher (counterpart of repro/launch/train.py).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 20 --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded 0; the
data is ``SyntheticTokens`` (seed 0), as in the reference. ``--device``
is the port's own flag: without it the model trains on the CUDA card.
Checkpoints go to ``--ckpt-dir`` and a run resumes from the newest one
there; without ``--ckpt-dir`` they go to a temporary directory that is
removed at the end. :func:`train` is the same run as a function,
returning the supervisor's history.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Dict, Optional, Sequence


def train(arch: str = "tinyllama-1.1b", steps: int = 50,
          smoke: bool = False, seq: int = 64, batch: int = 8,
          microbatches: int = 0, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 25, grad_compression: Optional[str] = None,
          device=None, optimizer: str = "adamw",
          lr: Optional[float] = None, warmup: int = 20,
          overrides: Optional[Dict] = None,
          fail_at: Sequence[int] = (),
          extra_inputs: Optional[Dict] = None) -> Dict:
    """Train ``arch`` for ``steps`` steps under the ``Supervisor``.

    The configuration is the arch's (``smoke``: its reduced one) with
    ``ce_seq_chunk = min(seq, 512)`` as in the reference, then
    ``overrides``. The rate follows ``cosine_schedule(lr, warmup,
    steps)``; ``lr`` defaults to the reference's (3e-3 smoke, 3e-4
    full). ``optimizer`` is ``"adamw"`` or ``"adafactor"``. A
    ``TrainingFailure`` is injected once at each step of ``fail_at``
    (the supervisor restores the newest checkpoint). ``extra_inputs``
    (name -> tensor on the device) joins every batch: a VLM's
    ``patches``, Whisper's ``frames``, which ``SyntheticTokens`` does not
    make (without frames Whisper raises ``KeyError``, as the reference's
    launcher does). On a card each step ends with a device
    synchronization, so the history's ``seconds`` are the step's.
    Returns ``{"history", "state", "model", "seconds", "resumed_from",
    "config"}``.
    """
    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data import SyntheticTokens
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model
    from repro_torch.optim import adafactor, adamw, cosine_schedule
    from repro_torch.runtime import StragglerMonitor, Supervisor
    from repro_torch.train.step import init_train_state, make_train_step

    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = cfg.replace(ce_seq_chunk=min(seq, 512), moe_groups=2,
                      **(overrides or {}))
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    peak = lr if lr is not None else (3e-3 if smoke else 3e-4)
    make_opt = {"adamw": adamw, "adafactor": adafactor}[optimizer]
    opt = make_opt(cosine_schedule(peak, warmup, steps))

    state = init_train_state(model, opt, torch.Generator(dev).manual_seed(0))
    # one process, as the reference's launcher on one host: no group, so
    # ``int8_ef`` has no reduction to compress (the reference passes no
    # pod axis either)
    train_step = make_train_step(model, opt, microbatches=microbatches,
                                 grad_compression=grad_compression)

    def step_fn(st, b):
        out = train_step(st, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    ds = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
    pending = set(fail_at)

    def injector(step):
        if step in pending:
            pending.discard(step)
            return RuntimeError(f"injected failure at step {step}")
        return None

    tmp = None if ckpt_dir else tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        sup = Supervisor(
            step_fn=step_fn,
            batch_fn=lambda s: {**{k: torch.as_tensor(v, dtype=torch.int64,
                                                      device=dev)
                                   for k, v in ds.batch(s).items()},
                                **(extra_inputs or {})},
            ckpt=CheckpointManager(ckpt_dir or tmp, keep=3),
            ckpt_every=ckpt_every,
            monitor=StragglerMonitor(n_hosts=1),
            failure_injector=injector if pending else None)
        # resume if a checkpoint exists (restart semantics)
        restored = sup.ckpt.restore_latest(like=state)
        start = 0
        if restored is not None:
            state, start = restored
        t0 = time.perf_counter()
        state = sup.run(state, start_step=start, num_steps=steps)
        dt = time.perf_counter() - t0
        sup.ckpt.wait()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return {"history": sup.history, "state": state, "model": model,
            "seconds": dt, "resumed_from": start if restored else None,
            "config": cfg}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", type=str, default=None,
                    choices=(None, "int8_ef"))
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    out = train(arch=args.arch, steps=args.steps, smoke=args.smoke,
                seq=args.seq, batch=args.batch,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                grad_compression=args.grad_compression, device=args.device)
    if out["resumed_from"] is not None:
        print(f"[train] resumed from step {out['resumed_from']}")
    losses = [h["metrics"]["loss"] for h in out["history"]
              if h["event"] == "step"]
    dt = out["seconds"]
    if not losses:
        print(f"[train] no steps to run ({dt:.1f}s)")
        return
    print(f"[train] {len(losses)} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.2f} s/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
