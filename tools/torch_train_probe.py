#!/usr/bin/env python3
"""Measure the port's training path on one CUDA card, beyond what
``chip_smoke.py``'s ``train`` phase prints.

    python3 tools/torch_train_probe.py
        [--only memory,experts,rates,profile,plain] [--src DIR]

- ``memory``: TinyLlama-1.1B's FULL throughput leg (B 8 x S 2,048, remat
  ``dots``) in 2 microbatches of 4 instead of ``chip_smoke.py``'s 4 of 2:
  the out-of-memory error it raises, or its record;
- ``experts``: Kimi K2's leg of ``chip_smoke.TRAIN_RUNS`` (2 layers,
  Adafactor, B 2) at 64, 48 and 40 experts, the count that leg trains
  at: each count's out-of-memory error, or its record;
- ``rates``: the TinyLlama and Mamba2 FULL throughput legs (the first
  two of ``chip_smoke.TRAIN_RUNS``) at the rates 1e-3, 3e-4 and 1e-4:
  losses, gradient norms, seconds a step;
- ``profile``: ``torch.profiler`` over one FULL step of each model after
  two warm ones: the summed kernel time, the launches, and the kernel
  time by operator and by kernel name (the 25 largest);
- ``plain``: Mamba2-1.3B's FULL forward on the plain branch (B 2, S
  2,048, the plain leg of ``lm_score``), the median of 7 after a warm-up,
  and the logits' sum, from the package under ``--src`` (default: this
  checkout's ``src``), so that two trees can be timed in turns in one
  call.

Prints the card's name and power limit, then one JSON line a
measurement. Needs a card: no measurement falls back to the CPU.
"""
import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dense_ssm_legs(cs):
    """(arch, batch, microbatches, steps) of TinyLlama's and Mamba2's
    legs, the first two of ``chip_smoke.TRAIN_RUNS``."""
    return [run[:4] for run in cs.TRAIN_RUNS[:2]]


def memory_rows(cs, device):
    arch, batch, _, steps = cs.TRAIN_RUNS[0][:4]
    try:
        rec, _ = cs.train_run(device, arch, batch, 2, steps, cs.TRAIN_LR)
    except torch.OutOfMemoryError as e:
        torch.cuda.empty_cache()
        return [{"probe": "memory", "arch": arch, "microbatches": 2,
                 "error": str(e)[:400]}]
    return [{"probe": "memory", "arch": arch, "microbatches": 2, **rec}]


def expert_rows(cs, device):
    arch, batch, microbatches, steps, optimizer, lr, overrides = next(
        run for run in cs.TRAIN_RUNS if "num_experts" in run[-1])
    rows = []
    for n in (64, 48, overrides["num_experts"]):
        row = {"probe": "experts", "arch": arch, "num_experts": n}
        try:
            rec, falls = cs.train_run(device, arch, batch, microbatches,
                                      steps, lr, optimizer,
                                      {**overrides, "num_experts": n})
            row.update(passes_check=falls, **{k: rec[k] for k in (
                "losses", "step_s", "max_memory_bytes")})
        except torch.OutOfMemoryError as e:
            row["error"] = str(e)[:400]
        torch.cuda.empty_cache()
        rows.append(row)
    return rows


def rate_rows(cs, device):
    rows = []
    for arch, batch, microbatches, steps in dense_ssm_legs(cs):
        for lr in (1e-3, 3e-4, 1e-4):
            rec, falls = cs.train_run(device, arch, batch, microbatches,
                                      steps, lr)
            rows.append({"probe": "rates", "arch": arch, "lr": lr,
                         "passes_check": falls,
                         **{k: rec[k] for k in (
                             "losses", "grad_norms", "loss_drop",
                             "step_s", "step_seconds", "mfu",
                             "max_memory_bytes")}})
    return rows


def profile_rows(cs, device):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train.step import init_train_state, make_train_step

    rows = []
    for arch, batch, microbatches, _ in dense_ssm_legs(cs):
        cfg = get_config(arch).replace(ce_seq_chunk=512)
        model = build_model(cfg, device)
        opt = adamw(cosine_schedule(cs.TRAIN_LR, 1, 6))
        state = init_train_state(model, opt,
                                 torch.Generator(device).manual_seed(0))
        step = make_train_step(model, opt, microbatches=microbatches)
        data = SyntheticTokens(cfg.vocab_size, cs.TRAIN_SEQ, batch, seed=0)

        def batch_of(s):
            return {k: torch.as_tensor(v, dtype=torch.int64, device=device)
                    for k, v in data.batch(s).items()}

        for s in range(2):
            state, _ = step(state, batch_of(s))
        torch.cuda.synchronize()
        b = batch_of(2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, b)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                          for e in prof.key_averages()), reverse=True)
        rows.append({"probe": "profile", "arch": arch,
                     "profiled_wall_s": wall,
                     "kernel_s": sum(e.time_range.elapsed_us()
                                     for e in kernels) / 1e6,
                     "launches": len(kernels),
                     "top_ms": [(round(t, 3), k[:100], c)
                                for t, k, c in by_name[:25]]})
        del model, state, step, prof
        torch.cuda.empty_cache()
    return rows


def plain_rows(device):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg, device).init_params(
        torch.Generator(device).manual_seed(0))
    tokens = torch.randint(3, cfg.vocab_size - 1, (2, 2048), device=device,
                           generator=torch.Generator(device).manual_seed(1))
    times = []
    with torch.inference_mode():
        model.logits({"tokens": tokens})
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.logits({"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    import repro_torch
    return [{"probe": "plain", "package": repro_torch.__file__,
             "median_ms": sorted(times)[3] * 1e3,
             "ms": [t * 1e3 for t in times],
             "logits_abs_sum": float(out.float().abs().sum())}]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only",
                        default="memory,experts,rates,profile,plain")
    parser.add_argument("--src", default=os.path.join(ROOT, "src"),
                        help="the package tree that 'plain' times")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_probe: CUDA is not available", file=sys.stderr)
        return 2
    probes = args.only.split(",")
    # the package comes from --src: imported before chip_smoke, which
    # puts this checkout's src first on the path
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch  # noqa: F401  (first, from --src)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    # as chip_smoke.main sets them: cuBLAS's workspace before CUDA starts,
    # float32 matmuls without TF32
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(cs.card_line(), flush=True)
    for name, fn in (("memory", lambda: memory_rows(cs, device)),
                     ("experts", lambda: expert_rows(cs, device)),
                     ("rates", lambda: rate_rows(cs, device)),
                     ("profile", lambda: profile_rows(cs, device)),
                     ("plain", lambda: plain_rows(device))):
        if name in probes:
            for row in fn():
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
