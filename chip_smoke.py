#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Canal on one NVIDIA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card and nvcc.
Phases (any failure raises, so the script exits non-zero). Every path
phase zeroes the launch counts just before it runs and reads them just
after; each must have launched the kernels it exists to drive.

1. build   — nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` into
             ``build/kernels/`` and, beside them, the kernels kept as
             they were before their redesign
             (``tools/ablation_kernels/*_first.cu``) into
             ``build/earlier/`` (one process per source, in parallel).
2. main    — one design point at the full size of the paper's artifact,
             ``cgra_amber.FULL`` (32x32, 5 tracks, 86,288 IR nodes):
             ``canal_torch.compile(FULL, use_kernels=True)`` on the card,
             place-and-route of the five bench apps (``auto`` strategies,
             which resolve to the minplus router and the batched
             annealer), bitstreams, and ``run_apps_batch`` over all five
             apps unstreamed and with ``io_chunk=8``. Outputs are checked
             against the port's scatter-based oracle
             (``use_kernels=False``), the two emulation modes against each
             other, and the pointwise app against its dataflow semantics
             (out = in + 1 + ... + 6). Kernels: fused batch and run,
             min-plus, boxes.
   smoke   — the placed nets' HPWL through ``ops.hpwl``, against numpy.
             No port path calls ``ops.hpwl`` yet, so its launches are this
             script's own check, not path coverage.
3. emulate — each routed app alone through ``CompiledFabric.emulate``
             (``FabricModule.run``: each sweep, one ``fabric_sweep``
             launch among its ops, replayed from a CUDA graph),
             bit-identical to phase 2's batched outputs; per app the wall
             ms, the launches and the card's ms per sweep.
4. verify  — ``CompiledFabric.verify()`` at FULL: the structural check
             and the exhaustive configuration sweep, 214,080 (mux, input)
             cases in chunks of 2,048 (``fabric_sweep_batch``).
5. serve   — ``canal_torch.serve`` on a fresh store, FULL submitted twice
             at once: one PnR computation, one coalesced request, five
             routed and emulated apps whose areas equal ``fab.area()``; a
             second service on the same store answers FULL from it with
             an equal record and no PnR.
6. engines — ``batched_vs_serial_emulation`` and
             ``fused_vs_unfused_emulation`` at 32x32, 5 tracks, B 8, T 16
             (each asserts bit-identical engines), and
             ``sharded_emulation_probe`` at the same size: ``run_batch``
             split over the card named twice (two threads, two streams),
             bit-identical to the unsplit run.
7. search  — ``canal_torch.search`` on an 8x8 base over ``num_tracks``
             2-5, ``budget=3``, store-backed (the one phase cut in size:
             every candidate is a whole DSE point); its frontier must not
             be empty.
8. rv      — the hybrid ready-valid interconnect (``RVFabric``) on
             ``cgra_amber.FULL`` with ``ready_valid=True``, not cut, in both
             FIFO modes (``canal_torch.compile``, ``split_fifo`` False /
             True): a stream of 64 tokens east across all 32 columns (31
             FIFO stages) under random sink backpressure through
             ``run_with_sources``, every token delivered once and in order;
             the same route under a sink never ready, where source ready
             must drop and full FIFOs absorb more than split ones; the
             routed ``pointwise`` app (``auto``: minplus router, batched
             annealer), its bitstream, and ``run_with_sources`` with its
             PE program for 64 tokens (placed and routed once, on the
             full-mode point). Each cycle's sweeps are one ``rv_sweeps``
             launch (launches = cycles); the first 4 cycles of each, run
             again on the
             card and on the port's CPU path, must agree bit for bit,
             FIFO state included, and the app's first 4 likewise with
             the card's eager sweeps. In full mode ``emulate`` runs the
             app on the static semantics, equal to ``run_apps_batch``.
8b. two_layer — the benchmark's two-layer cell at its size
             (``amber_two_layer.emulate_pred``: FULL with five 1-bit tracks
             beside the five 16-bit ones, its PEs with the 1-bit inputs):
             the traffic's four predicate apps placed and routed with its
             ``pnr`` settings (each routes 1-bit nets), bitstreams, and
             ``run_apps_batch`` of its 16 lanes for T cycles, unstreamed
             and with ``io_chunk=8``, both equal to the scatter oracle and
             to ``canalbench/reference.py``; each fused launch's
             ``emu.fused`` span must name the variant the size rule gives
             (the global-memory one at this size).
9. lm_score — the LM substrate's full-sequence forward, ``logits`` of
             the ten LM configs at full width (``LM_DEPTHS``: every one
             at its full depth but Kimi K2, cut to its dense layer and
             one MoE layer of 384 experts; random weights from a seed),
             B 2, S 2,048 (InternVL2 with 256 patches before the tokens,
             Whisper over 1,500 frames), with ``attn_impl="kernel"``,
             one model at a time (built, scored, served, freed; its
             build seconds and peak memory recorded): one
             ``flash_attention`` launch a layer for the dense, MoE and
             VLM families (TinyLlama 22, Phi-3 32 at head dim 96, Qwen3
             40, DeepSeek-Coder 62, Kimi K2 2 at 112, Granite 32,
             InternVL2 24), one ``ssd_scan`` a layer for Mamba2 (48), and
             none for RecurrentGemma (windowed attention) and Whisper,
             which stay on the plain path as in the reference. Each
             model's launches are checked exactly. The same forward with
             ``attn_impl="plain"`` (the same weights) must pass the
             ``LM_*`` gate (largest difference, largest per-position
             relative error, argmax agreement); both must be finite. The
             kernel path with the kernel's plain version in its place
             (the witness) must pass the gate too, and with a wrong
             function in its place (the control), fail it; the kernel
             rows of phase 11 must likewise reject the control. The two
             kernel-free models are held instead to the port's CPU path
             on the same weights, at full width and a cut depth, in
             float32 (``CPU_CHECK``).
   lm_smoke_kernels — every smoke config whose family reaches a kernel
             (TinyLlama, Mamba2, Phi-3, Qwen3, DeepSeek-Coder, Kimi K2,
             Granite, InternVL2: head dims 8 and 16, Mamba2's chunk 32,
             P 16, N 16), ``logits`` with ``attn_impl="kernel"`` at B 2 x
             S 96, each its own phase ``lm_smoke_kernels:<arch>``: one
             launch of its family's kernel a layer, exactly, and within
             the ``LM_*`` gate of the plain path (no witness or control:
             the smoke shapes only have to reach the kernels).
10. lm_serve — ``ServeEngine`` on each model: 8 requests (prompts of
             3-11 tokens, batch 4, 16 new tokens, ``max_seq`` 128, 512
             for InternVL2's patches; patches and frames as
             ``extra_inputs``), twice; every request gets a token, every
             logit is finite, and the second run returns the same tokens.
             Serving runs the cached forward, which the reference keeps
             on its plain path (the flash kernel takes queries from
             position 0; a Mamba-2 cache step takes the stateful SSD), so
             this phase launches no kernel and must launch none.
11. kernels — every kernel against its plain PyTorch version on the card,
             at its path's shapes (bit-identical for the fabric kernels,
             min-plus included; within a stated tolerance for the two
             float kernels of the LM path, which must reject
             ``lm_score``'s controls), with the kernel's and the
             plain version's times, the least time the card could take
             (``bound``) and its share of ``ms`` (``bound_share``); for
             ``flash_attention`` also the time of PyTorch's
             ``scaled_dot_product_attention`` on the same inputs
             (``library_ms``, a yardstick the port never calls) and the
             achieved TFLOP/s by the function's 4 D FLOPs a causal pair
             (``tflops``), at TinyLlama's shape and, under ``shapes``, at
             Phi-3's (D 96), Kimi K2's (D 112) and Qwen3's (D 128), in
             float16 at TinyLlama's, and at D 16 and RecurrentGemma's D
             256 (``FLASH_SHAPES``), each with its plan (kernel, tile
             width, padded row); ``ssd_scan`` also at the smoke
             configs' (chunk 32, P 16, N 16; ``SSD_SHAPES``);
             ``minplus_step`` is timed at B 32 (the row) and at B 8
             (``by_batch``). ``ms`` and
             ``plain_ms`` are device time: back-to-back calls captured in
             one CUDA graph and timed over a replay (``timing: graph``;
             the fused kernels' plain versions, thousands of small
             launches, by CUDA events). ``call_ms`` is the cost of one
             call from Python, wrapper included, by CUDA events. The two
             fused rows also give their variant (cluster size or
             ``global``), the clusters the card holds at once, the sweeps
             a launch runs, the microseconds a sweep and the share of a
             sweep's shared-memory reads that stay in the reading block;
             they come twice, at FULL (path ``main``) and at phase 8b's
             two-layer array with its PE layout (path ``two_layer``:
             ``pe_inputs`` 7, the predicate ops among the random
             programs, B 16).
             ``net_bboxes`` and ``hpwl`` are also timed at the
             reference's batched design shape (``design``: 1,048,576
             nets at K 4), each in turns with its earlier kernel, the
             median of five rounds. ``fabric_sweep``, ``fabric_sweep_batch``,
             ``ssd_scan``, ``net_bboxes`` and ``hpwl`` also give the time
             of the kernel as it stood before its redesign, built from
             ``tools/ablation_kernels/`` beside the library, held to the
             same plain version and timed on the
             same inputs (``earlier_ms``); ``fabric_sweep`` also the
             device time of one whole sweep of ``run`` (``sweep_ms``:
             the kernel, the hold, the re-pin and the PE cores, as the
             graph replays them). ``rv_sweeps`` runs one FULL cycle
             of each FIFO mode at the east stream's depth (127 split, 5
             full; the split one is the row, both under ``shapes``),
             from phase 8's stalled route under a random drive and sink
             readiness: the kernel and its plain version on copies of
             the same buffers, data, valid and ready equal in both.

12. train — the training path through ``repro_torch.launch.train.train`` (the
             ``Supervisor``, ``SyntheticTokens``, the plain branch under
             autograd; no kernel, and it must launch none), after ``lm_serve``
             has freed its models. Throughput: TinyLlama-1.1B at FULL (22
             layers, remat ``dots``), global batch 8 x S 2,048 in 4
             microbatches, AdamW, 6 steps; Mamba2-1.3B at FULL (48 layers),
             batch 4 x S 2,048, 4 steps; Granite-MoE (Adafactor),
             InternVL2-2B (AdamW, 256 stub patches), RecurrentGemma-2B
             (Adafactor) and Whisper-medium (AdamW, 1,500 stub frames) at
             FULL, each full depth, remat ``full``, batch 4 x S 2,048, 4
             steps; Kimi K2 at its dense layer and one MoE layer,
             Adafactor, batch 2, its experts cut from 384 to 40
             (``TRAIN_RUNS``); random
             weights from a seed, no checkpoint writes. Every loss and gradient norm must be finite,
             and the lowest loss of the last half of the steps must sit
             ``TRAIN_DROP`` of the first below it; the same run at rate 0 (the
             control) must fail that check. Per model: the median seconds a
             step without the first, tokens/s, the peak of
             ``torch.cuda.max_memory_allocated`` and ``mfu`` (6 N D over the
             step time and the card's dense bf16 peak; N an MoE model's
             active parameters). Restart: TinyLlama at
             full width and 2 layers, Adafactor, under
             ``torch.use_deterministic_algorithms``: a checkpoint every 2
             steps, a ``TrainingFailure`` injected at step 3, the supervisor
             restores step 2 and finishes; the final state must equal an
             uninterrupted run's bit for bit, and a save then restore of it
             must give every tensor back bit for bit (in a temporary directory,
             removed afterwards).
13. examples — the port's four examples (``examples/torch_*.py``:
             quickstart, the DSE example, serving, training) on the card at
             their default sizes, each asserting its own result.

Before the last line it prints each phase's seconds and launches, the
per-app PnR seconds, the emulation times, the ``train`` and ``kernels``
JSON lines and the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``. Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

T = 16                       # emulated cycles (the DSE executor's default)
IO_CHUNK = 8
#: the benchmark's cell on the two-layer array (phase 8b follows its
#: configuration and traffic), and the seed of its stimulus here
PRED_CELL = "amber_two_layer.emulate_pred"
PRED_SEED = 29
#: H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the
#: CUDA-core rate (float32 outside the tensor cores), used for the
#: integer and float compare/add work of these kernels
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), the bound of
#: attention's bf16 products
TENSOR_BF16_FLOPS_PER_S = 989e12

#: the LM path: the archs and the depth each runs (``None``: its FULL
#: depth; every arch at full width), batch and sequence of ``lm_score``;
#: the serving run. Kimi K2 at its 61 layers is ~2 TB of bf16 weights:
#: cut to its leading dense layer and one MoE layer of 384 experts
#: (~40 GB). InternVL2 scores 256 patches before its 2,048 tokens and
#: serves with them, so its serving cache holds 512 positions
LM_DEPTHS = {"tinyllama-1.1b": None, "mamba2-1.3b": None,
             "phi3-mini-3.8b": None, "qwen3-14b": None,
             "deepseek-coder-33b": None, "kimi-k2-1t-a32b": 2,
             "granite-moe-3b-a800m": None, "internvl2-2b": None,
             "recurrentgemma-2b": None, "whisper-medium": None}
LM_BATCH, LM_SEQ = 2, 2048
SERVE = dict(requests=8, batch=4, max_new=16, max_seq=128)
SERVE_MAX_SEQ = {"vlm": 512}
#: the kernel each family's ``lm_score`` launches once a layer (RG-LRU
#: models and Whisper attend on the plain path, as the reference does)
FAMILY_KERNEL = {"dense": "flash_attention", "moe": "flash_attention",
                 "vlm": "flash_attention", "ssm": "ssd_scan",
                 "hybrid": None, "audio": None}
#: the kernel-free families' card logits against the port's CPU path:
#: the depth cut (full width: one RecurrentGemma group and its two tail
#: layers; two Whisper encoder and decoder layers), batch and sequence,
#: float32 on both (TF32 off: sums in another order only), max
#: |difference| over the largest |logit|
CPU_CHECK = {
    "recurrentgemma-2b": lambda cfg: cfg.replace(num_layers=5),
    "whisper-medium": lambda cfg: cfg.replace(
        num_layers=2, encdec=dataclasses.replace(cfg.encdec,
                                                 encoder_layers=2)),
}
CPU_CHECK_BATCH, CPU_CHECK_SEQ, CPU_CHECK_TOL = 1, 256, 1e-3
#: ``flash_attention`` is also timed, B 2, S 2,048, at (Hq, Hkv, D,
#: dtype): the head dims of Phi-3 (96, MHA), Kimi K2 (112, 64 q heads on
#: 8 kv heads) and Qwen3 (128, 40 on 8), bf16; TinyLlama's shape in
#: float16 (the kernel instantiated for __half); D 16 (the smoke configs'
#: head dim, the tile of 64) at 16 heads on 4; and RecurrentGemma's D 256
#: (10 q heads on 1, the tile of 256), which no path sends to the kernel
FLASH_SHAPES = ((32, 32, 96, "bfloat16"), (64, 8, 112, "bfloat16"),
                (40, 8, 128, "bfloat16"), (32, 4, 64, "float16"),
                (16, 4, 16, "bfloat16"), (10, 1, 256, "bfloat16"),
                (8, 2, 320, "bfloat16"), (8, 2, 512, "bfloat16"))
#: ``ssd_scan`` is also timed at the smoke configs' instantiation
#: (chunk 32, P 16, N 16), BH 128, L 2,048
SSD_SHAPES = ((128, 2048, 16, 16, 32),)
#: the ``lm_smoke_kernels`` step: every smoke config whose family reaches
#: a kernel, at its smoke width and depth (head dim 8 or 16; Mamba2's
#: chunk 32, P 16, N 16: shapes the kernels' first instantiations did not
#: take), ``logits`` on the kernel path at B 2 x S 96 held to the plain
#: path by the ``LM_*`` gate
LM_SMOKE = ("tinyllama-1.1b", "mamba2-1.3b", "phi3-mini-3.8b", "qwen3-14b",
            "deepseek-coder-33b", "kimi-k2-1t-a32b", "granite-moe-3b-a800m",
            "internvl2-2b")
LM_SMOKE_BATCH, LM_SMOKE_SEQ = 2, 96
#: kernel vs plain logits at bf16, at full depth with random weights
#: (``logit_gap``): max |difference| over the largest |logit|, the
#: largest per-position relative error, and the share of positions whose
#: argmax agrees. On an H100 80GB HBM3 at 700 W the sound comparisons
#: (plain branch, witness) read at most 4.96%, 15.2% and at least 95.2%;
#: the controls at least 42.5%, 114%, and 49.5% (TinyLlama) or 100%
#: (Mamba2: its argmax cannot tell a wrong SSD apart). The gate sits
#: between them.
LM_TOL, LM_ROW_TOL, LM_ARGMAX = 0.10, 0.40, 0.90
#: kernel vs plain on random inputs at the path's shapes. Attention:
#: |got - want| <= atol + rtol |want|, rtol one bf16 ulp at least (both
#: round an f32 result to bf16 once, summed in another order). The SSD in
#: f32, summed in another order.
FLASH_ATOL, FLASH_RTOL = 1e-4, 2.0 ** -7
SSD_TOL = 1e-4
_P, _I = ctypes.c_void_p, ctypes.c_int
#: the kernels as they stood before their redesign, kept unchanged in
#: ``tools/ablation_kernels/`` and timed beside the committed ones
#: (``earlier_ms``): kernel -> (source, C signature)
EARLIER = {"fabric_sweep": ("fabric_sweep_first.cu", [_P] * 4 + [_I] * 2
                            + [_P]),
           "fabric_sweep_batch": ("fabric_sweep_first.cu",
                                  [_P] * 4 + [_I] * 4 + [_P]),
           "ssd_scan": ("ssd_scan_first.cu", [_P] * 6 + [_I] * 5 + [_P]),
           "net_bboxes": ("hpwl_first.cu", [_P] * 3 + [_I] * 2 + [_P]),
           "hpwl": ("hpwl_first.cu", [_P] * 3 + [_I] * 2 + [_P])}
#: the ready-valid phase: tokens a source sends, cycles of the stream and
#: of the routed app, the never-ready run's cycles (enough to fill 31 FIFO
#: stages), the cycles run again on the CPU (few: a CPU cycle at the app's
#: depth takes ~0.5 s at FULL) and eagerly on the card, and the share of
#: cycles a backpressured sink is ready
RV_TOKENS, RV_STREAM_T, RV_APP_T, RV_FILL_T = 64, 192, 96, 96
RV_CPU_T, RV_EAGER_T, RV_SINK_READY = 4, 4, 0.6
#: the reference docstring's batched evaluation (``kernels/hpwl.py``):
#: 64 chains x 4 candidates x 4,096 nets at K 4; the rounds in which the
#: box kernels and their earlier versions are timed in turns
BOX_DESIGN = (64 * 4 * 4096, 4)
BOX_ROUNDS = 5
#: the training phase: (arch, global batch, microbatches, steps) at S
#: 2,048, the peak rate (cosine from the first step), and the share of
#: the first step's loss by which the lowest loss of the last half of the
#: steps must be lower. On an H100 80GB HBM3 at 700 W the loss of a FULL
#: model jumps from step to step (random bf16 weights; TinyLlama at 3e-4
#: read 11.04, 10.06, 15.90, 10.67, 13.31, 9.35) and diverged at 1e-3; at
#: 1e-4 the last half's lowest loss sat 34% (TinyLlama) and 43% (Mamba2)
#: below the first, at rate 0 within 1% of it. TinyLlama takes 4
#: microbatches of 2: with 2 of 4, ``dots`` keeps 22 f32 score matrices
#: of 2 GiB, and the first forward ran out of the card's 80 GB (75.3 GiB
#: allocated)
#:
#:
#: The other four families train at full width and depth (InternVL2 with
#: 256 stub patches, Whisper over 1,500 stub frames), under remat
#: ``full`` (their ``dots`` keeps every layer's float32 attention scores:
#: ~13 GB a sequence for Granite) and without microbatches (whose float32
#: gradient sums cost 4 bytes a parameter). Granite-MoE (3.4 B
#: parameters; peak 57.5 GB) and RecurrentGemma (2.3 B) take Adafactor:
#: AdamW's two float32 moments, old and new side by side in the update,
#: put RecurrentGemma at 74.7 GB and Granite past the card. Kimi K2 runs
#: its dense layer and one MoE layer with Adafactor, the experts cut from
#: 384 (19.9 G parameters, ~40 GB of bf16 weights before gradients and
#: moments) to 40, the most of 64, 48, 40 that fit the card in
#: ``tools/torch_train_probe.py`` (peak 73.1 GB; out of memory fails the
#: phase). Their rates, on an
#: H100 80GB HBM3 at 700 W: at 1e-4 the new models' losses jump (Whisper
#: 131, 102, 149, 125: under the check) or climb (RecurrentGemma with
#: Adafactor 232, 462, 566, 596: Adafactor's second moment has no bias
#: correction, so its first updates are several times AdamW's at one
#: rate); at 3e-5 (AdamW) and 1e-5 (Adafactor) each fell 15-29% in 4
#: steps
TRAIN_SEQ = 2048
#: (arch, global batch, microbatches, steps, optimizer, peak rate,
#: config overrides; ``num_experts`` cuts an MoE config's experts)
TRAIN_RUNS = (
    ("tinyllama-1.1b", 8, 4, 6, "adamw", 1e-4, {}),
    ("mamba2-1.3b", 4, 0, 4, "adamw", 1e-4, {}),
    ("granite-moe-3b-a800m", 4, 0, 4, "adafactor", 1e-5, {"remat": "full"}),
    ("internvl2-2b", 4, 0, 4, "adamw", 3e-5, {"remat": "full"}),
    ("recurrentgemma-2b", 4, 0, 4, "adafactor", 1e-5, {"remat": "full"}),
    ("whisper-medium", 4, 0, 4, "adamw", 3e-5, {"remat": "full"}),
    ("kimi-k2-1t-a32b", 2, 0, 4, "adafactor", 1e-5,
     {"num_layers": 2, "num_experts": 40}),
)
#: the restart leg's rate, and the loss check
TRAIN_LR, TRAIN_DROP = 1e-4, 0.05
#: the restart leg: steps, batch, a checkpoint every, the failure's step
RESTART_STEPS, RESTART_BATCH, RESTART_EVERY, RESTART_FAIL = 5, 4, 2, 3


#: the kernels each path exists to launch (phase 11 reads each kernel's
#: launches from its path)
PHASE_KERNELS = {
    "dryrun": ("flash_attention",),
    "main": ("fabric_fused_batch", "fabric_fused_run", "minplus_step",
             "net_bboxes"),
    "smoke": ("hpwl",),
    "emulate": ("fabric_sweep",),
    "verify": ("fabric_sweep_batch",),
    "serve": ("fabric_fused_batch", "minplus_step", "net_bboxes"),
    "engines": ("fabric_sweep", "fabric_sweep_batch", "fabric_fused_batch"),
    "search": (),
    # PnR of the routed app; emulate on the static semantics
    "rv": ("minplus_step", "net_bboxes", "fabric_sweep", "rv_sweeps"),
    "two_layer": ("fabric_fused_batch", "fabric_fused_run", "minplus_step",
                  "net_bboxes"),
    # each model's ``lm_score:<arch>`` phase launches its family's kernel
    # (FAMILY_KERNEL); ``lm_score`` sums them
    "lm_score": ("flash_attention", "ssd_scan"),
    # the cached forward never reaches a kernel (see the docstring)
    "lm_serve": (),
    # training runs the plain branch: the kernels have no backward
    "train": (),
    # the examples drive the fabric kernels on their own small fabrics;
    # none is required of them
    "examples": (),
}
KERNEL_PATH = {"fabric_sweep": "emulate", "fabric_sweep_batch": "verify",
               "hpwl": "smoke", "flash_attention": "lm_score",
               "ssd_scan": "lm_score", "rv_sweeps": "rv"}


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, reps=5):
    """Mean milliseconds per call over ``reps`` back-to-back calls from
    Python, by CUDA events, after one warm-up call (host gaps between
    launches included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20, replays=3):
    """Device milliseconds per call: ``reps`` back-to-back calls captured
    in one CUDA graph, timed by CUDA events over ``replays`` replays
    after a warm one, so the host's per-call cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def timings(fn, plain, reps=20, plain_reps=20):
    """``ms``/``plain_ms`` as graph-captured device time, and ``call_ms``
    as the kernel's cost per call from Python."""
    return {"ms": graph_ms(fn, reps), "plain_ms": graph_ms(plain, plain_reps),
            "call_ms": cuda_ms(fn, reps), "timing": "graph"}


def bound(n_bytes, n_ops, ops_per_s=CUDA_CORE_OPS_PER_S):
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the given peak (the CUDA-core rate unless
    stated)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


# ------------------------------------------------------------------ main path
def counter_stimulus(result):
    """The DSE executor's stimulus: a counter 1..T on every app input."""
    return {result.placement[name]: np.arange(1, T + 1, dtype=np.int32)
            for name, inst in result.packed.placeable.items()
            if inst.kind == "io_in"}


def main_path(spec, device):
    """compile -> PnR -> bitstream -> batched emulation; returns the
    compiled fabric, the routed apps and a report."""
    import canal_torch
    from repro_torch.core.pnr.app import BENCH_APPS
    from repro_torch.fabric import AppEmulator, run_apps_batch

    report = {}
    t0 = time.perf_counter()
    fab = canal_torch.compile(spec, device=device, use_kernels=True)
    fabric = fab.fabric()
    report["compile_s"] = time.perf_counter() - t0
    report["nodes"] = fabric.arrays.num_nodes
    log(f"compiled {fab!r}: {fabric.arrays.num_nodes} nodes, "
        f"{fabric.num_config} config slots, {fabric.num_pe} PEs, "
        f"{fabric.num_io} IOs, {fabric.num_mem} MEMs in "
        f"{report['compile_s']:.1f} s")

    routed, pnr_s, words = {}, {}, {}
    for name, make in BENCH_APPS.items():
        r = fab.place_and_route(make())
        if not r.success:
            raise RuntimeError(f"{name}: PnR failed: {r.error}")
        routed[name] = r
        pnr_s[name] = r.seconds
        words[name] = len(fab.bitstream(r))
        log(f"{name}: routed by {r.route_strategy}, placed by "
            f"{r.place_strategy}, {r.seconds:.2f} s, "
            f"{r.timing['critical_path_ns']:.3f} ns, {words[name]} words")
    report["pnr_s"] = pnr_s
    report["bitstream_words"] = words
    report["strategies"] = {n: (r.route_strategy, r.place_strategy)
                            for n, r in routed.items()}

    emus = [AppEmulator.from_pnr(fabric, r.packed, r)
            for r in routed.values()]
    ins = [counter_stimulus(r) for r in routed.values()]
    report["depths"] = [e.depth for e in emus]
    emu_ms = {}
    outs = {}
    for mode, chunk in (("unstreamed", None), ("io_chunk", IO_CHUNK)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[mode] = run_apps_batch(emus, ins, T, io_chunk=chunk)
        torch.cuda.synchronize()
        emu_ms[mode] = (time.perf_counter() - t0) * 1e3
    report["emulation_ms"] = emu_ms
    return fab, routed, emus, ins, outs, report


def pin_table(result):
    """A routed app's placed nets (two or more placeable members) as
    padded (n_nets, K, 2) pin coordinates and an (n_nets, K) mask."""
    from repro_torch.core.pnr.batched_anneal import _net_members

    order = list(result.packed.placeable)
    members = _net_members(result.packed,
                           {n: i for i, n in enumerate(order)})
    k = max(len(m) for m in members)
    pins = np.zeros((len(members), k, 2), np.int32)
    mask = np.zeros((len(members), k), np.int32)
    for n, mem in enumerate(members):
        for j, gi in enumerate(mem):
            pins[n, j] = result.placement[order[gi]]
            mask[n, j] = 1
    return pins, mask


def placed_hpwl(result, device):
    """Per-net HPWL of a routed app's placement (``ops.hpwl``)."""
    from repro_torch.kernels import ops

    pins, mask = pin_table(result)
    return ops.hpwl(torch.as_tensor(pins, device=device),
                    torch.as_tensor(mask, device=device)).cpu().numpy()


def check_main_path(fab, routed, emus, ins, outs, report):
    """What came out is right: streamed == unstreamed == the scatter
    oracle, and the pointwise app computes in + 1 + ... + 6."""
    from repro_torch.core.pnr.app import BENCH_APPS
    from repro_torch.fabric import AppEmulator, run_apps_batch

    for name, (route, place) in report["strategies"].items():
        if (route, place) != ("minplus", "batched"):
            raise AssertionError(f"{name}: auto resolved to {route}/{place}")
    for a, b in zip(outs["unstreamed"], outs["io_chunk"]):
        for coord in a:
            if not np.array_equal(a[coord], b[coord]):
                raise AssertionError("io_chunk emulation diverged")
    oracle_fab = fab.fabric(use_kernels=False)
    oracle_emus = [AppEmulator.from_pnr(oracle_fab, r.packed, r)
                   for r in routed.values()]
    oracle = run_apps_batch(oracle_emus, ins, T)
    for got, want in zip(outs["unstreamed"], oracle):
        for coord in want:
            if not np.array_equal(got[coord], want[coord]):
                raise AssertionError("kernel emulation != scatter oracle")
    r = routed["pointwise"]
    app_consts = sum(inst.const
                     for inst in BENCH_APPS["pointwise"]().instances.values()
                     if inst.kind == "const")
    x = np.arange(1, T + 1, dtype=np.int32)
    y = outs["unstreamed"][list(routed).index("pointwise")][
        r.placement["out0"]]
    nz = np.nonzero(y)[0]
    if not len(nz):
        raise AssertionError("pointwise: no output observed")
    lat = int(nz[0])
    if not np.array_equal(y[lat:], x[:T - lat] + app_consts):
        raise AssertionError(f"pointwise: {y} != in + {app_consts}")
    return {"pointwise_latency": lat, "pointwise_offset": int(app_consts)}


def hpwl_phase(routed, device):
    """Each routed app's total placed HPWL through ``ops.hpwl``, equal
    to numpy's."""
    total = {}
    for name, r in routed.items():
        total[name] = int(placed_hpwl(r, device).sum())
        pins, mask = pin_table(r)
        m = mask > 0
        want = sum(int(np.ptp(pins[i, m[i], 0]) + np.ptp(pins[i, m[i], 1]))
                   for i in range(len(mask)))
        if total[name] != want:
            raise AssertionError(f"{name}: placed HPWL {total[name]} != "
                                 f"{want}")
    return total


# ------------------------------------------------------- the slice-2 paths
def emulate_phase(fab, routed, ins, outs):
    """Each routed app alone through ``CompiledFabric.emulate`` (its
    sweeps replayed from a CUDA graph), equal to the batched run. Per
    app: wall ms, ``fabric_sweep`` launches, and the card's ms per sweep
    (CUDA events from before the app's run to after it, over its
    launches: host gaps between the replays included); beside them the
    ms of the host's part that binds the app to the fabric
    (``AppEmulator.from_pnr``, timed apart: ``emulate`` runs it too)."""
    from repro_torch.fabric import AppEmulator
    from repro_torch.kernels import build

    per_app = {}
    for (name, r), stim, want in zip(routed.items(), ins,
                                     outs["unstreamed"]):
        t0 = time.perf_counter()
        AppEmulator.from_pnr(fab.fabric(), r.packed, r)
        bind_ms = (time.perf_counter() - t0) * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = build.LAUNCHES["fabric_sweep"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        got = fab.emulate(r, stim, cycles=T)
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        sweeps = build.LAUNCHES["fabric_sweep"] - before
        device_ms = start.elapsed_time(end)
        per_app[name] = {"ms": wall_ms, "bind_ms": bind_ms,
                         "fabric_sweep": sweeps, "device_ms": device_ms,
                         "device_ms_per_sweep": device_ms / max(sweeps, 1)}
        log(f"emulate {name}: {wall_ms:.1f} ms, {sweeps} sweeps, "
            f"{device_ms / max(sweeps, 1):.4f} device ms a sweep")
        for coord in want:
            if not np.array_equal(got[coord], want[coord]):
                raise AssertionError(f"{name}: emulate != batched run")
    return {"emulate_ms": {k: v["ms"] for k, v in per_app.items()},
            "per_app": per_app}


def verify_phase(fab):
    """``fab.verify()`` at full size: it passes and checks every
    (mux, input) connection once."""
    report = fab.verify(use_kernels=True)
    if not report.ok():
        raise AssertionError(report.render())
    expect = sum(s.fanin for s in fab.fabric().config_slots)
    msgs = [d.message for d in report.diagnostics
            if d.rule == "config-sweep"]
    checked = int(msgs[0].split()[0]) if msgs else -1
    if checked != expect:
        raise AssertionError(f"config sweep checked {checked} "
                             f"connections, expected {expect}")
    return {"connections_checked": checked, "rules": list(report.rules_run)}


def _json(rec):
    return json.loads(json.dumps(rec, sort_keys=True, default=str))


def serve_phase(spec, area, device):
    """The DSE service on a fresh store: two concurrent requests for
    ``spec`` cost one PnR; a second service answers from the store."""
    import tempfile
    import canal_torch

    with tempfile.TemporaryDirectory(prefix="canal_torch_store_") as root:
        with canal_torch.serve(store=root, emulate_cycles=T,
                               use_kernels=True, device=device) as svc:
            first = svc.submit(spec)
            deadline = time.time() + 60
            while not svc._inflight and time.time() < deadline:
                time.sleep(0.01)
            second = svc.submit(spec)
            rec, rec2 = first.result(), second.result()
            st = svc.stats()
        if st["executor"]["pnr_computations"] != 1 or st["coalesced"] != 1:
            raise AssertionError(f"serve: expected one PnR and one "
                                 f"coalesced request, got {st}")
        if _json(rec) != _json(rec2):
            raise AssertionError("serve: coalesced record differs")
        apps = rec["apps"]
        bad = [n for n, a in apps.items()
               if not a["success"] or "out_checksum" not in
               a.get("emulation", {})]
        if len(apps) != 5 or bad:
            raise AssertionError(f"serve: apps not routed and emulated: "
                                 f"{bad or sorted(apps)}")
        for k in ("sb_area", "cb_area"):
            if rec[k] != area[k]:
                raise AssertionError(f"serve: {k} {rec[k]} != {area[k]}")
        with canal_torch.serve(store=root, emulate_cycles=T,
                               use_kernels=True, device=device) as svc2:
            t0 = time.perf_counter()
            warm = svc2.query(spec)
            warm_s = time.perf_counter() - t0
            st2 = svc2.stats()
        if (st2["hits"], st2["executor"]["pnr_computations"]) != (1, 0):
            raise AssertionError(f"serve: second service missed: {st2}")
        if _json(warm) != _json(rec):
            raise AssertionError("serve: stored record differs")
    return {"gen_pnr_seconds": rec["gen_pnr_seconds"],
            "metrics": rec["metrics"],
            "checksums": {n: a["emulation"]["out_checksum"]
                          for n, a in apps.items()},
            "strategies": {n: [a["route_strategy"], a["place_strategy"]]
                           for n, a in apps.items()},
            "cold_latency_s": st["latency_max_s"], "warm_query_s": warm_s}


def engines_phase(device):
    from repro_torch.core import dse

    kw = dict(width=32, height=32, num_tracks=5, batch=8, cycles=T,
              use_kernels=True, device=device)
    split = dse.sharded_emulation_probe(devices=2, **kw)
    if "error" in split or split["devices"] != 2:
        raise AssertionError(f"engines: the batch split failed: {split}")
    return {"batched_vs_serial": dse.batched_vs_serial_emulation(**kw),
            "fused_vs_unfused": dse.fused_vs_unfused_emulation(
                repeats=1, **kw),
            "split": split}


def search_phase(device):
    """Search over ``num_tracks`` on an 8x8 base, store-backed."""
    import tempfile
    import canal_torch

    base = canal_torch.InterconnectSpec(width=8, height=8, io_ring=True,
                                        reg_density=1.0)
    with tempfile.TemporaryDirectory(prefix="canal_torch_store_") as root:
        result = canal_torch.search(base, {"num_tracks": (2, 3, 4, 5)},
                                    budget=3, store=root, use_kernels=True,
                                    device=device)
    if not result.frontier:
        raise AssertionError("search: empty frontier")
    used = set()
    for e in result.evaluated:
        for a in e.record["apps"].values():
            used.update((a.get("route_strategy"), a.get("place_strategy")))
    return {"frontier": [e.to_dict() for e in result.frontier],
            "evaluated": len(result.evaluated), "strategies": sorted(
                x for x in used if x), "stats": result.stats}


# ------------------------------------------------ the ready-valid fabric
def rv_sources(fab, src, rng, cycles, ready=RV_SINK_READY, drain=0):
    """``run_with_sources``'s inputs: ``RV_TOKENS`` random words at IO
    ``src``, every sink ready at random (``ready`` of cycles) but for the
    last ``drain`` cycles."""
    streams = np.zeros((cycles, fab.num_io), np.int32)
    lens = np.zeros(fab.num_io, np.int32)
    streams[:RV_TOKENS, src] = rng.integers(1, 1 << 16, RV_TOKENS)
    lens[src] = RV_TOKENS
    sink = (rng.random((cycles, fab.num_io)) < ready).astype(np.int32)
    if drain:
        sink[-drain:] = 1
    return streams, lens, sink


def rv_counts(fab):
    from repro_torch.kernels import build

    return {"rv_sweeps": build.LAUNCHES["rv_sweeps"],
            "kernel_cycles": fab.kernel_cycles}


def rv_timed(fab, *args, **kw):
    """``run_with_sources`` on the card: its outputs on the host, ms per
    cycle by CUDA events, and what it counted: ``rv_sweeps`` launches
    and kernel cycles."""
    before = rv_counts(fab)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    outs = fab.run_with_sources(*args, **kw)
    end.record()
    torch.cuda.synchronize()
    cycles = outs[0].shape[0]
    return ([o.cpu().numpy() for o in outs], start.elapsed_time(end) / cycles,
            {k: v - before[k] for k, v in rv_counts(fab).items()})


def rv_kernel_case(fab, config, depth):
    """One FULL cycle's inputs for the ``rv_sweeps`` row, at the
    stream's ``depth``: the FIFO state ``fab`` last left (the stalled
    route's full stages), a seeded random drive and sink readiness, the
    cycle started (``_rv_start``) and the kernel's tables resolved."""
    rng = np.random.default_rng(11)
    n_io = fab.num_io
    cyc = fab._rv_cycle(config, None)
    fab._rv_start(cyc, fab.last_state,
                  *(fab._ints(x) for x in (
                      rng.integers(0, 1 << 16, n_io, dtype=np.int32),
                      rng.integers(0, 2, n_io, dtype=np.int32),
                      rng.integers(0, 2, n_io, dtype=np.int32))))
    return {"mode": fab.fifo_mode, "depth": depth, "cyc": cyc,
            "tables": fab._rv_tables(cyc), "pes": fab.num_pe,
            "connections": int(fab.arrays.fanin_count.sum())}


def rv_kernel_row(cases):
    """``rv_sweeps`` against its plain version on one FULL cycle of each
    FIFO mode (``rv_kernel_case``): both run once on copies of the same
    buffers and must leave data, valid and ready equal in both buffers
    (``max_abs_err``), then each is timed on copies of its own. The
    row's shape is the split mode's (``amber_rv.east``'s depth), both
    modes under ``shapes``. The bound counts 3 operations a connection a
    sweep, as ``canalbench/roofline.py`` does; a sweep reads one
    selected source a node, so that counts about 3x the work."""
    from repro_torch.kernels import rv_sweep

    shapes = []
    for case in cases:
        cyc, depth = case["cyc"], case["depth"]

        def copies():
            return [tuple(b.clone() for b in cyc[k]) for k in "dvr"]

        def args(bufs):
            return (case["tables"], *bufs, cyc["pins_d"], cyc["pins_v"],
                    cyc["fix_mask"], cyc["fix_val"], depth)

        got, want = copies(), copies()
        rv_sweep.rv_sweeps(*args(got))
        rv_sweep.rv_sweeps_plain(*args(want))
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max())
                  for gs, ws in zip(got, want) for g, w in zip(gs, ws))
        if err:
            raise AssertionError(f"rv_sweeps {case['mode']} differs from "
                                 f"its plain version by {err}")
        timed, plain = copies(), copies()
        b_ms, b_by = bound(0, 3 * depth * case["connections"])
        shapes.append({
            "fifo": case["mode"], "depth": depth, "max_abs_err": err,
            **timings(lambda: rv_sweep.rv_sweeps(*args(timed)),
                      lambda: rv_sweep.rv_sweeps_plain(*args(plain)),
                      reps=10, plain_reps=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "cluster": case["tables"]["cluster"]})
    row = next(x for x in shapes if x["fifo"] == "split")
    case = cases[0]
    return {"name": "rv_sweeps", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rv_sweeps.cu",
            "replaces": "none: the CUDA-graph replays of "
                        "RVFabric._forward_sweep / _backward_sweep",
            **{k: row[k] for k in ("ms", "plain_ms", "call_ms", "timing",
                                   "bound_ms", "bound_by")},
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "library_ms": None, "shapes": shapes,
            "shape": {"N": case["tables"]["n"], "P": case["pes"],
                      "connections": case["connections"], "fifo": "split",
                      "depth": row["depth"], "cluster": row["cluster"]}}


def rv_kernel_cycles(mode, counts, cycles):
    """At FULL every cycle's sweeps are one ``rv_sweeps`` launch."""
    want = {"rv_sweeps": cycles, "kernel_cycles": cycles}
    if counts != want:
        raise AssertionError(f"rv {mode}: counted {counts}, not {want}")


def rv_same(name, card, other, args):
    """The same ``run_with_sources(*args)`` on the card's fabric
    (``use_kernels``) and on ``other`` (the CPU's, or the card's eager
    sweeps): io_data, io_valid, accepted and the FIFO state after it
    equal bit for bit.
    Returns the seconds ``other`` took."""
    runs = []
    for f in (card, other):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = f.run_with_sources(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        runs.append([o.cpu().numpy() for o in outs]
                    + [f.last_state[k].cpu().numpy() for k in ("slots",
                                                               "occ")])
    labels = ("io_data", "io_valid", "accepted", "slots", "occ")
    for label, a, b in zip(labels, *runs):
        if not np.array_equal(a, b):
            raise AssertionError(f"rv {name}: {label} differs")
    return seconds


def rv_mode(rv, routed, rng):
    """One FIFO mode of the ready-valid phase (see the docstring): ``rv``
    compiled in that mode, ``routed`` the pointwise app's (PnR result,
    emulator) on the full-mode point. Returns its record and the stream's
    cycle for phase 11's ``rv_sweeps`` row (``rv_kernel_case``)."""
    from repro_torch.fabric import RVFabric, east_route, run_apps_batch

    fab = rv.fabric()
    mode = fab.fifo_mode
    t0 = time.perf_counter()
    cpu = RVFabric(rv.interconnect, fifo_mode=mode, device="cpu")
    rec = {"cpu_build_s": time.perf_counter() - t0}
    io = {c: i for i, c in enumerate(fab.io_coords)}
    width = fab.ic.dims()[0]

    # 1. a stream east across every column
    edges = east_route(fab.ic)
    config = fab.route_to_config(edges)
    # full FIFOs register ready, so a cycle's ready chain ends at the next
    # stage (``depth_for_route``); split stages chain it combinationally
    # through every stage of the route, and fewer backward sweeps than its
    # nodes lose tokens (in the reference too): one sweep an edge
    depth = len(edges) + 2 if mode == "split" else fab.depth_for_route(edges)
    src, dst = io[(0, 1)], io[(width - 1, 1)]
    stages = sum(1 for _, d in edges if d.kind.name == "REGISTER")
    streams, lens, sink = rv_sources(fab, src, rng, RV_STREAM_T, drain=64)
    outs, ms, counts = rv_timed(fab, config, streams, lens, sink,
                                depth=depth)
    rv_kernel_cycles(mode, counts, RV_STREAM_T)
    od, ov, acc = outs
    got = od[:, dst][acc[:, dst] > 0]
    if not np.array_equal(got, streams[:RV_TOKENS, src]):
        raise AssertionError(f"rv {mode}: the stream delivered {len(got)} of "
                             f"{RV_TOKENS} tokens, or out of order")
    cpu_s = rv_same(f"{mode} stream", fab, cpu,
                    (config, streams, lens, sink[:RV_CPU_T], None, depth))
    valid = np.zeros((RV_FILL_T, fab.num_io), np.int32)
    valid[:, src] = 1
    orr = fab.run_stream(config, valid, valid,
                         np.zeros_like(valid), depth=depth)[2].cpu().numpy()
    absorbed = int(orr[:, src].sum())
    if orr[-1, src] != 0 or absorbed >= RV_FILL_T:
        raise AssertionError(f"rv {mode}: source ready never dropped under a "
                             f"stalled sink ({absorbed} absorbed)")
    case = rv_kernel_case(fab, config, depth)
    rec["stream"] = {"cycles": RV_STREAM_T, "depth": depth,
                     "fifo_stages": stages, "ms_per_cycle": ms,
                     "launches": counts, "tokens": RV_TOKENS,
                     "delivered": int(len(got)), "absorbed_never_ready":
                     absorbed, "cpu_equal_cycles": RV_CPU_T}

    # 2. the routed pointwise app: its configuration and PE program
    r, emu = routed
    src, dst = io[r.placement["in0"]], io[r.placement["out0"]]
    streams, lens, sink = rv_sources(fab, src, rng, RV_APP_T)
    outs, ms, counts = rv_timed(fab, emu.config, streams, lens, sink,
                                pe_cfg=emu.pe_cfg, depth=emu.depth)
    rv_kernel_cycles(mode, counts, RV_APP_T)
    cpu_s += rv_same(f"{mode} app", fab, cpu,
                     (emu.config, streams, lens, sink[:RV_CPU_T], emu.pe_cfg,
                      emu.depth))
    eager_ms = rv_same(f"{mode} app, eager on the card", fab,
                       rv.fabric(use_kernels=False),
                       (emu.config, streams, lens, sink[:RV_EAGER_T],
                        emu.pe_cfg, emu.depth)) * 1e3 / RV_EAGER_T
    # the device time of one replayed sweep of each direction
    cyc = fab._rv_cycle(emu.config, emu.pe_cfg)
    fab._rv_start(cyc, fab.init_state(), *(fab._zeros(fab.num_io),) * 2,
                  None)
    sweep_ms = {"forward": graph_ms(lambda: fab._forward_sweep(cyc, 0, 1)),
                "backward": graph_ms(lambda: fab._backward_sweep(cyc, 0, 1))}
    rec["app"] = {"cycles": RV_APP_T, "depth": emu.depth,
                  "ms_per_cycle": ms, "eager_ms_per_cycle": eager_ms,
                  "sweep_ms": sweep_ms, "launches": counts,
                  "tokens": RV_TOKENS, "delivered": int(outs[2][:, dst].sum()),
                  "cpu_equal_cycles": RV_CPU_T}
    rec["cpu_leg_s"] = cpu_s
    if mode == "full":
        stim = {r.placement["in0"]: np.arange(1, T + 1, dtype=np.int32)}
        got = rv.emulate(r, stim, cycles=T)
        want = run_apps_batch([emu], [stim], T)[0]
        if any(not np.array_equal(got[c], want[c]) for c in want):
            raise AssertionError("rv: emulate != run_apps_batch")
        rec["app"]["emulate_equal"] = True
    log(f"rv {mode}: stream {rec['stream']}; app {rec['app']}")
    return rec, case


def rv_phase(spec, device):
    """The ready-valid fabric at ``spec`` (FULL) in both FIFO modes; the
    pointwise app placed and routed once, on the spec's default (full)
    point, its configuration run in both. Returns the record and each
    mode's ``rv_kernel_case``."""
    import canal_torch
    from repro_torch.core.pnr.app import BENCH_APPS
    from repro_torch.fabric import AppEmulator, RVFabric

    rng = np.random.default_rng(7)
    out, cases = {}, []
    routed = None
    for mode, split in (("full", False), ("split", True)):
        t0 = time.perf_counter()
        rv = canal_torch.compile(spec.replace(ready_valid=True,
                                              split_fifo=split),
                                 device=device, use_kernels=True)
        fab = rv.fabric()
        if not isinstance(fab, RVFabric) or fab.fifo_mode != mode:
            raise AssertionError(f"rv: fabric() is {type(fab).__name__}, "
                                 f"{getattr(fab, 'fifo_mode', None)}, not "
                                 f"{mode}")
        compile_s = time.perf_counter() - t0
        pnr = {}
        if routed is None:
            r = rv.place_and_route(BENCH_APPS["pointwise"]())
            if not r.success:
                raise RuntimeError(f"rv: PnR failed: {r.error}")
            if (r.route_strategy, r.place_strategy) != ("minplus",
                                                        "batched"):
                raise AssertionError(f"rv: auto resolved to "
                                     f"{r.route_strategy}/{r.place_strategy}")
            routed = (r, AppEmulator.from_pnr(fab, r.packed, r))
            pnr = {"pnr_s": r.seconds, "bitstream_words": len(rv.bitstream(r))}
        rec, case = rv_mode(rv, routed, rng)
        out[mode] = {"compile_s": compile_s, **pnr, **rec}
        cases.append(case)
    full, split = (out[m]["stream"]["absorbed_never_ready"]
                   for m in ("full", "split"))
    if full <= split:
        raise AssertionError(f"rv: full FIFOs absorbed {full}, split {split}")
    return out, cases


# ---------------------------------------------------- the two-layer array
def two_layer_phase(device):
    """The benchmark's two-layer cell at its size: ``amber_two_layer``'s
    spec (FULL with five 1-bit tracks beside the five 16-bit ones), its
    traffic's predicate apps placed and routed with its ``pnr``
    settings, bitstreams, and ``run_apps_batch`` of its ``lanes`` (the
    apps in turn, seeded 16-bit stimulus) for T cycles, unstreamed
    (``fabric_fused_batch`` a cycle) and with ``io_chunk``
    (``fabric_fused_run``). Both equal the scatter oracle
    (``use_kernels=False``) and ``canalbench/reference.py``; every 1-bit
    net is routed, and each fused launch's ``emu.fused`` span names the
    variant the size rule gives. Returns the record and the fabric (for
    the kernel rows)."""
    import canal_torch
    from canalbench import harness, reference
    from canalbench.kinds import app_graph, make_spec
    from repro_torch import obs
    from repro_torch.fabric import AppEmulator, run_apps_batch
    from repro_torch.kernels import fabric_step as fs

    cell = harness.find_cell(harness.load_benchmark(), PRED_CELL)
    traffic = harness.load_traffic(cell["traffic"])
    pnr = {k: tuple(v) if isinstance(v, list) else v
           for k, v in traffic["pnr"].items()}
    t0 = time.perf_counter()
    fab = canal_torch.compile(make_spec(harness.load_config(cell["config"])),
                              device=device, use_kernels=True)
    fabric = fab.fabric()
    n, p = fabric.arrays.num_nodes, fabric.fused_tables["num_pe_slots"]
    rec = {"compile_s": time.perf_counter() - t0, "nodes": n,
           "connections": int((fabric.arrays.src < n).sum()),
           "pe": fabric.num_pe, "pe_inputs": int(fabric.pe_in.shape[1]),
           "io_columns": fabric.num_io}
    if not fabric.pred:
        raise AssertionError("two_layer: the fabric has no 1-bit PE ports")
    log(f"two_layer: {n} nodes, {rec['connections']} connections, "
        f"{fabric.num_pe} PEs in {rec['compile_s']:.1f} s")

    routed, rec["pnr_s"], rec["bitstream_words"], rec["nets_1b"] = \
        {}, {}, {}, {}
    for name in traffic["apps"]:
        since = time.perf_counter()
        r = fab.place_and_route(app_graph(reference.load_app(name)), **pnr)
        if not r.success:
            raise RuntimeError(f"two_layer {name}: PnR failed: {r.error}")
        routed[name] = r
        rec["pnr_s"][name] = r.seconds
        rec["bitstream_words"][name] = len(fab.bitstream(r))
        rec["nets_1b"][name] = [s.attrs.get("nets_1b", 0)
                                for s in obs.spans("pnr.route", since)]
        if not all(rec["nets_1b"][name]):
            raise AssertionError(f"two_layer {name}: no 1-bit net routed "
                                 f"({rec['nets_1b'][name]})")
        log(f"two_layer {name}: {r.seconds:.2f} s, "
            f"{rec['nets_1b'][name]} 1-bit nets")

    lanes = [traffic["apps"][k % len(traffic["apps"])]
             for k in range(traffic["lanes"])]
    stims, ins = [], []
    for k, name in enumerate(lanes):
        rng = np.random.default_rng([PRED_SEED, k])
        app = reference.load_app(name)
        stims.append({i: rng.integers(0, 1 << 16, T, dtype=np.int64)
                      for i in reference.app_ios(app, "io_in")})
        ins.append({tuple(routed[name].placement[i]): v
                    for i, v in stims[-1].items()})
    emus = [AppEmulator.from_pnr(fabric, routed[a].packed, routed[a])
            for a in lanes]
    t = fabric._fused_args()
    outs, rec["emulation_ms"], rec["fused_clusters"] = {}, {}, {}
    rec["fused_plan"] = {}
    for mode, chunk, kernel in (
            ("unstreamed", None, "fabric_fused_batch"),
            ("io_chunk", IO_CHUNK, "fabric_fused_run")):
        want_cluster, room = fs.fused_plan(kernel, t["src"],
                                           t["pe_res_idx"], t["pe_in"])
        rec["fused_plan"][mode] = {"cluster": want_cluster, "room": room}
        torch.cuda.synchronize()
        since = time.perf_counter()
        outs[mode] = run_apps_batch(emus, ins, T, io_chunk=chunk)
        torch.cuda.synchronize()
        rec["emulation_ms"][mode] = (time.perf_counter() - since) * 1e3
        clusters = {s.attrs["cluster"]
                    for s in obs.spans("emu.fused", since)}
        rec["fused_clusters"][mode] = sorted(clusters)
        if clusters != {want_cluster}:
            raise AssertionError(f"two_layer {mode}: emu.fused clusters "
                                 f"{clusters}, the size rule "
                                 f"{want_cluster}")
    oracle_fab = fab.fabric(use_kernels=False)
    oracle = run_apps_batch([AppEmulator.from_pnr(oracle_fab, routed[a].packed,
                                                  routed[a]) for a in lanes],
                            ins, T)
    for k, name in enumerate(lanes):
        r = routed[name]
        for coord in oracle[k]:
            for mode in outs:
                if not np.array_equal(outs[mode][k][coord],
                                      oracle[k][coord]):
                    raise AssertionError(f"two_layer lane {k} ({name}) "
                                         f"{mode} != the scatter oracle")
        app = reference.load_app(name)
        for o, w in reference.evaluate(app, stims[k]).items():
            got = np.asarray(outs["io_chunk"][k][tuple(r.placement[o])],
                             np.int64)
            if not np.array_equal(got, w):
                raise AssertionError(f"two_layer lane {k} ({name}) {o} != "
                                     f"the reference")
    rec["lanes"], rec["cycles"] = len(lanes), T
    return rec, fabric


# ------------------------------------------------------------ kernel checks
def random_workload(fabric, batch, seed):
    """``dse._random_fabric_workload``'s draws on the given fabric: random
    selects (so cyclic configurations with per-lane depths occur),
    random stimulus, per-config combinational depths."""
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 4, (batch, fabric.num_config)).astype(np.int32)
    ext = rng.integers(0, 256, (batch, T, fabric.num_io)).astype(np.int32)
    depths = np.array([fabric.combinational_depth(c) for c in cfgs],
                      np.int32)
    return cfgs, ext, depths


def fused_workload(fabric, device, batch):
    """The fused kernels' inputs at ``fabric``'s size and PE layout:
    ``batch`` random configurations (``random_workload``), random PE
    programs (over the predicate ops too where the PEs have the 1-bit
    inputs), cycle 0's pinned values. Returns (batch_args, run_args,
    run_kw, depths)."""
    from repro_torch.core.lowering import WORD
    from repro_torch.kernels import fabric_step as fs

    cfgs, ext, depths_np = random_workload(fabric, batch, seed=0)
    max_depth = int(depths_np.max())
    sel = fabric._selects(torch.as_tensor(cfgs, device=device))
    rng = np.random.default_rng(1)
    p = fabric.fused_tables["num_pe_slots"]
    n_ops = len(fs.PE_OPS) + (len(fs.PRED_OPS) if fabric.pred else 0)
    pe_cfg = {"op": rng.integers(0, n_ops, (batch, p)),
              "const": rng.integers(0, 1 << 16, (batch, p)),
              "imm_mask": rng.random((batch, p, 4)) < 0.2,
              "imm_val": rng.integers(0, 1 << 16, (batch, p, 4))}
    op, const, imm_mask, imm_val = fabric._norm_pe_cfg(pe_cfg, batch)
    t = fabric._fused_args()
    s = fabric.stream_tables()
    depths = torch.as_tensor(depths_np, device=device)
    state = fabric.init_state_batch(batch)
    ext_t = torch.as_tensor(ext, device=device)
    pin_vals = fabric._pin(torch.zeros_like(sel), state, ext_t[:, 0])
    batch_args = (pin_vals, sel, pin_vals, depths, op, const, imm_mask,
                  imm_val, t["src"], t["keep"], t["pin_mask"], t["pe_in"],
                  t["pe_res_idx"])

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=device)

    run_args = (sel, ext_t, depths, op, const, imm_mask, imm_val, t["src"],
                t["keep"], t["pin_mask"], i32(s["pin_src"]), t["pe_in"],
                t["pe_res_idx"], i32(s["reg_src"]), i32(s["mem_in"]),
                i32(s["io_out"]))
    run_kw = dict(n_reg=s["n_reg"], n_io=fabric.num_io,
                  n_mem=fabric.num_mem, max_depth=max_depth, word=WORD)
    return batch_args, run_args, run_kw, depths_np


def local_share(batch_args, cluster, ordered=True):
    """Share of a sweep's shared-memory reads that land in the reading
    block, for lanes split over ``cluster`` blocks in contiguous ranges
    of ceil((N + 1) / cluster) node slots, nodes placed by
    ``cluster_plan.order`` (``ordered``) or in IR order: one read per node that
    is not a PE output, one per operand of a PE output that is neither an
    immediate nor absent fan-in (three for res0, one for res1)."""
    from repro_torch.kernels import cluster_plan
    from repro_torch.kernels import fabric_step as fs

    (_, sel, _, _, _, _, imm_mask, _, src, keep, pin_mask, pe_in,
     pe_res_idx) = batch_args
    n = sel.shape[1]
    p = pe_in.shape[0]
    chunk = -(-(n + 1) // cluster)
    slot = (cluster_plan.order(src)[1].long() if ordered else
            torch.arange(n + 1, device=sel.device))
    i = torch.arange(n, device=sel.device)
    own = (pin_mask > 0) | (keep > 0)
    reads = torch.where(own[None], i[None], fs._picked(src, sel).long())
    res = pe_res_idx.long()
    is_pe = res < 2 * p
    home = slot[:n] // chunk
    same = (slot[reads] // chunk == home[None])[:, ~is_pe]
    local, total = int(same.sum()), same.numel()
    node, k = i[is_pe], res[is_pe] // 2
    for j in range(3):
        u = pe_in[k, j].long()
        live = (((j == 0) | (res[is_pe] % 2 == 0)) & (u < n))[None] \
            & (imm_mask[:, k, j] <= 0)
        hit = slot[reads[:, u.clamp(max=n - 1)]] // chunk == home[node][None]
        local += int((hit & live).sum())
        total += int(live.sum())
    return local / total


def fused_shape(kernel, batch_args, depths, max_depth, cycles, ms):
    """The fused rows' variant (``fabric_step.fused_plan`` of the tables in
    ``batch_args``), a block's PE-record room and shared memory, and sweep
    counts: ``sweeps`` is the deepest lane's sweeps a launch (lanes run
    side by side), ``lane_sweeps`` their sum."""
    from repro_torch.kernels import cluster_plan
    from repro_torch.kernels import fabric_step as fs

    src, pe_in, pe_res_idx = batch_args[8], batch_args[11], batch_args[12]
    n = src.shape[0]
    pred = fs.pe_outputs(pe_in) == 3
    cluster, room = fs.fused_plan(kernel, src, pe_res_idx, pe_in)
    run = np.minimum(np.maximum(depths, 0), max_depth)
    sweeps = cycles * int(run.max())
    return {"variant": cluster or "global", "room": room,
            "block_smem_bytes": (fs.fused_block_bytes(n, cluster, room, pred)
                                 if cluster else None),
            "active_clusters": (cluster_plan.active_clusters(
                kernel, n, cluster, room, pred) if cluster else None),
            "sweeps": sweeps, "lane_sweeps": cycles * int(run.sum()),
            "us_per_sweep": ms * 1e3 / max(sweeps, 1)}


def fabric_kernel_rows(fabric, device, batch, path="main"):
    """The two fused rows at ``fabric``'s size and PE layout, their
    launches read from ``path``'s phase."""
    from repro_torch.kernels import fabric_step as fs

    batch_args, run_args, run_kw, depths_np = fused_workload(fabric, device,
                                                             batch)
    max_depth = run_kw["max_depth"]
    n = fabric.arrays.num_nodes
    p = fabric.fused_tables["num_pe_slots"]
    pred = fabric.pred
    cluster = fs.fused_plan("fabric_fused_batch", batch_args[8],
                            batch_args[12], batch_args[11])[0]
    # local_share reads the two-output record layout only
    share = ({"ordered": local_share(batch_args, cluster),
              "ir_order": local_share(batch_args, cluster, ordered=False)}
             if cluster and not pred else None)
    bkw = dict(max_depth=max_depth, word=run_kw["word"])

    rows = []
    got = fs.fabric_fused_batch(*batch_args, **bkw)
    want = fs.fabric_fused_batch_plain(*batch_args, **bkw)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_fused_batch differs (max {err})")
    sweeps = int(np.minimum(depths_np, max_depth).sum())
    b_ms, b_by = bound(nbytes(*batch_args[1:]) + nbytes(got), sweeps * n)
    ms = graph_ms(lambda: fs.fabric_fused_batch(*batch_args, **bkw), 20)
    rows.append({
        "name": "fabric_fused_batch", "route": "cuda", "path": path,
        "source": "src/repro_torch/kernels/csrc/fabric_step.cu",
        "replaces": "src/repro/kernels/fabric_step.py:324",
        "max_abs_err": err, "ms": ms,
        "call_ms": cuda_ms(lambda: fs.fabric_fused_batch(*batch_args,
                                                         **bkw)),
        "plain_ms": cuda_ms(lambda: fs.fabric_fused_batch_plain(
            *batch_args, **bkw), reps=2),
        "timing": "graph",
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": batch, "N": n, "F": fabric.arrays.max_fanin,
                  "P": p, "pe_inputs": int(batch_args[11].shape[1]),
                  "max_depth": max_depth,
                  "depths": depths_np.tolist(), "local_share": share,
                  **fused_shape("fabric_fused_batch", batch_args, depths_np,
                                max_depth, 1, ms)}})

    got = fs.fabric_fused_run(*run_args, chunk=IO_CHUNK, **run_kw)
    want = fs.fabric_fused_run_plain(*run_args, chunk=IO_CHUNK, **run_kw)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_fused_run differs (max {err})")
    b_ms, b_by = bound(nbytes(*run_args) + nbytes(got), T * sweeps * n)
    ms = graph_ms(lambda: fs.fabric_fused_run(*run_args, chunk=IO_CHUNK,
                                              **run_kw), 5)
    rows.append({
        "name": "fabric_fused_run", "route": "cuda", "path": path,
        "source": "src/repro_torch/kernels/csrc/fabric_step.cu",
        "replaces": "src/repro/kernels/fabric_step.py:519",
        "max_abs_err": err, "ms": ms,
        "call_ms": cuda_ms(lambda: fs.fabric_fused_run(
            *run_args, chunk=IO_CHUNK, **run_kw)),
        "plain_ms": cuda_ms(lambda: fs.fabric_fused_run_plain(
            *run_args, chunk=IO_CHUNK, **run_kw), reps=1),
        "timing": "graph",
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": batch, "T": T, "N": n, "n_io": fabric.num_io,
                  "R": run_kw["n_reg"], "M": fabric.num_mem,
                  "max_depth": max_depth, "local_share": share,
                  **fused_shape("fabric_fused_run", batch_args, depths_np,
                                max_depth, T, ms)}})
    return rows


def minplus_row(fab, device):
    """Exact agreement at N = tiles of the fabric for B in {1, 8, 32}, on
    the router's own coarse weights; times at B = 32 (the row) and B = 8
    (the common bucket, in ``by_batch``)."""
    from repro_torch.kernels import minplus as mp

    res = fab.resources()
    coarse = res.coarse()
    w_np = coarse.lower_bound_weights(res.base).T.astype(np.float32)
    w = torch.as_tensor(np.ascontiguousarray(w_np), device=device)
    n = w.shape[0]
    rng = np.random.default_rng(2)
    err = 0.0
    by_b = {}
    for b in (1, 8, 32):
        d0 = np.full((b, n), mp.INF, np.float32)
        live = max(1, (3 * b) // 4)             # the rest: padding lanes
        d0[np.arange(live), rng.choice(n, live, replace=False)] = 0.0
        d0 = torch.as_tensor(d0, device=device)
        got = mp.minplus_wavefront(d0, w)
        want = d0
        for _ in range(max(1, -(-max(n - 1, 1) // 8))):
            nd = want
            for _ in range(8):
                nd = mp.minplus_step_plain(nd, w)
            if torch.equal(nd, want):
                break
            want = nd
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"minplus_wavefront differs at B={b}")
        if not torch.equal(mp.minplus_step(d0, w),
                           mp.minplus_step_plain(d0, w)):
            raise AssertionError(f"minplus_step differs at B={b}")
        err = max(err, float((got - want).abs().max()))
        if b > 1:                      # the common bucket and the largest
            b_ms, b_by = bound(nbytes(d0, w, d0), 2 * b * n * n)
            by_b[b] = {**timings(lambda: mp.minplus_step(d0, w),
                                 lambda: mp.minplus_step_plain(d0, w)),
                       "bound_ms": b_ms, "bound_by": b_by}
    return {"name": "minplus_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/minplus.cu",
            "replaces": "src/repro/kernels/minplus.py:80",
            "max_abs_err": err, **by_b[32], "library_ms": None,
            "shape": {"B": 32, "N": n},
            "by_batch": {str(b): {k: r[k] for k in ("ms", "plain_ms",
                                                    "call_ms", "bound_ms")}
                         for b, r in by_b.items()}}


def interleaved_ms(fns, reps, rounds=BOX_ROUNDS):
    """The median device ms of each of ``fns``, graph-timed (``graph_ms``)
    in ``rounds`` rounds that take the functions in turns."""
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(graph_ms(fn, reps))
    return [float(np.median(t)) for t in times]


def box_shape(name, device, pins, mask, earlier, reps):
    """``net_bboxes`` or ``hpwl`` on one pin table: the kernel (and the
    kernel as it stood before its redesign, ``earlier``) held bit for bit
    to the plain version, all three timed on the same inputs, beside the
    byte bound. The kernel and the earlier one are timed in turns, the
    median of ``BOX_ROUNDS`` rounds: at the launch floor one reading
    moves by ~0.1 us."""
    from repro_torch.kernels import build, hpwl

    fn, plain = {"net_bboxes": (hpwl.net_bboxes, hpwl.net_bboxes_plain),
                 "hpwl": (hpwl.hpwl, hpwl.hpwl_plain)}[name]
    p_t = torch.as_tensor(pins, device=device)
    m_t = torch.as_tensor(mask, device=device)
    got = fn(p_t, m_t)
    want = plain(p_t, m_t)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"{name} differs (max {err})")
    n, k = mask.shape
    old = torch.empty_like(want)

    def launch_earlier():
        build.check(earlier(p_t.data_ptr(), m_t.data_ptr(), old.data_ptr(),
                            n, k, build.stream_ptr(device)), f"earlier {name}")
    launch_earlier()
    torch.cuda.synchronize()
    if not torch.equal(old, want):
        raise AssertionError(f"the earlier {name} differs from the plain "
                             f"version")
    ms, old_ms = interleaved_ms((lambda: fn(p_t, m_t), launch_earlier), reps)
    b_ms, b_by = bound(nbytes(p_t, m_t, got), 4 * n * k)
    return {"max_abs_err": err, "ms": ms,
            "plain_ms": graph_ms(lambda: plain(p_t, m_t), reps),
            "call_ms": cuda_ms(lambda: fn(p_t, m_t), reps),
            "timing": f"graph, median of {BOX_ROUNDS} rounds",
            "earlier_ms": old_ms, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"n_nets": n, "K": k,
                      "tiles": dict(zip(("G", "blocks", "threads"),
                                        hpwl.box_tiles(n, k)))}}


def design_boxes(seed):
    """``BOX_DESIGN``'s pin table: random pins, ~30% masked, every fifth
    net empty."""
    n, k = BOX_DESIGN
    rng = np.random.default_rng(seed)
    pins = rng.integers(0, 32, (n, k, 2)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.7).astype(np.int32)
    mask[::5] = 0
    return pins, mask


def box_row(name, replaces, path, earlier, device):
    """A box kernel's row: ``path`` (its path's pin table) gives the row's
    numbers, ``design`` those at ``BOX_DESIGN``."""
    row = box_shape(name, device, *path, earlier[name], reps=50)
    design = box_shape(name, device, *design_boxes(8), earlier[name],
                       reps=20)
    row["max_abs_err"] = max(row["max_abs_err"], design["max_abs_err"])
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hpwl.cu",
            "replaces": replaces, **row, "library_ms": None,
            "design": {k: design[k] for k in
                       ("ms", "call_ms", "plain_ms", "earlier_ms",
                        "bound_ms", "bound_by", "shape")}}


def bbox_row(routed, device, earlier):
    """Random nets with empty ones, at the (n_nets, K) of the largest
    bench app's pin table, and at the design shape."""
    from repro_torch.core.pnr.batched_anneal import _net_members

    shapes = []
    for r in routed.values():
        idx = {name: i for i, name in enumerate(r.packed.placeable)}
        members = _net_members(r.packed, idx)
        shapes.append((len(members), max(len(m) for m in members)))
    n, k = max(shapes)
    rng = np.random.default_rng(3)
    pins = rng.integers(0, 32, (n, k, 2)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.7).astype(np.int32)
    mask[:: 5] = 0                                   # empty nets
    return box_row("net_bboxes", "src/repro/kernels/hpwl.py:111",
                   (pins, mask), earlier, device)


def sweep_bytes(src, sel):
    """Bytes a sweep ``out[b, i] = vals[b, src[i, sel[b, i]]]`` must move,
    in 4-byte words each read or written once: every select, each
    distinct ``src`` entry the selects pick, each distinct value a
    configuration reads, and every output. Counted from this run's
    selects, not from the whole ``src`` and ``vals`` tables."""
    n, f = src.shape
    b = sel.shape[0]
    flat = (torch.arange(n, device=src.device) * f)[None, :] + sel.long()
    src_used = torch.zeros(n * f, dtype=torch.bool, device=src.device)
    src_used[flat.reshape(-1)] = True
    picked = src.reshape(-1)[flat].long()
    vals_used = torch.zeros((b, n + 1), dtype=torch.bool, device=src.device)
    vals_used.scatter_(1, picked, True)
    words = 2 * b * n + int(src_used.sum()) + int(vals_used.sum())
    return 4 * words


def start_earlier():
    """Start one nvcc process for each ``EARLIER`` source, into
    ``build/earlier/``; returns {source: (library path, process)}."""
    from repro_torch.kernels import build

    out = os.path.join(ROOT, "build", "earlier")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for src in sorted({src for src, _ in EARLIER.values()}):
        lib = os.path.join(out, src[:-3] + ".so")
        procs[src] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared",
             os.path.join(ROOT, "tools", "ablation_kernels", src), "-o",
             lib], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def finish_earlier(procs):
    """Wait for ``start_earlier``'s builds; returns {kernel: its C entry
    point}."""
    libs = {}
    for src, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{out}")
        libs[src] = ctypes.CDLL(lib)
    fns = {}
    for name, (src, argtypes) in EARLIER.items():
        fn = getattr(libs[src], "canal_" + name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def earlier_ms(name, launch, got, want, reps, **tol):
    """Device ms of the earlier kernel ``name`` (``launch()`` writes
    ``got``), after holding its result to ``want`` as the committed
    kernel's is held (bit for bit unless ``tol`` is given)."""
    launch()
    torch.cuda.synchronize()
    same = (torch.allclose(got, want, **tol) if tol
            else torch.equal(got, want))
    if not same:
        raise AssertionError(f"the earlier {name} differs from the plain "
                             f"version")
    return graph_ms(launch, reps)


def sweep_rows(fab, routed, device, earlier):
    """``fabric_sweep`` at FULL on a routed app's configuration, with the
    device time of ``run``'s whole sweep around it, and
    ``fabric_sweep_batch`` at the configuration sweep's chunk shape
    (2,048 cases x N + 1), each beside ``earlier`` (the kernels before
    their redesign)."""
    from repro_torch.core import verify
    from repro_torch.fabric import AppEmulator
    from repro_torch.kernels import build
    from repro_torch.kernels import fabric_step as fs

    fabric = fab.fabric()
    a = fabric.arrays
    n = a.num_nodes
    src = fabric._dev("src", a.src, torch.int32)
    rng = np.random.default_rng(4)
    vals_np = rng.integers(0, 1 << 16, n + 1).astype(np.int32)
    vals_np[n] = 0
    vals = torch.as_tensor(vals_np, device=device)
    r = routed["pointwise"]
    emu = AppEmulator.from_pnr(fabric, r.packed, r)
    sel = fabric._selects(emu.config[None])[0]
    rows = []
    got = fs.fabric_sweep(vals, src, sel)
    want = fs.fabric_sweep_plain(vals, src, sel)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_sweep differs (max {err})")
    b_ms, b_by = bound(sweep_bytes(src, sel[None]), n)
    first = torch.empty_like(want)

    def launch_first():
        build.check(earlier["fabric_sweep"](
            vals.data_ptr(), src.data_ptr(), sel.data_ptr(), first.data_ptr(),
            n, a.max_fanin, build.stream_ptr(device)),
            "earlier fabric_sweep")
    cyc = fabric._cycle(emu.config, emu.pe_cfg)
    fabric._start_cycle(cyc, cyc["vals"][0])
    rows.append({
        "name": "fabric_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fabric_sweep.cu",
        "replaces": "src/repro/kernels/fabric_step.py:135",
        "max_abs_err": err,
        # into one buffer, as ``run`` calls it and the first kernel runs
        **timings(lambda: fs.fabric_sweep(vals, src, sel, out=got),
                  lambda: fs.fabric_sweep_plain(vals, src, sel, out=got),
                  reps=50, plain_reps=50),
        "earlier_ms": earlier_ms("fabric_sweep", launch_first, first, want,
                                 reps=50),
        "sweep_ms": graph_ms(lambda: fabric._sweep(cyc, *cyc["vals"]),
                             reps=50),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": n, "F": a.max_fanin,
                  "grid": dict(zip(("blocks", "threads"),
                                   fs.sweep_tiles(n)))}})

    slot_ids, sels = verify.sweep_cases(fabric)
    b = min(2048, len(slot_ids))
    sel_b = verify.case_selects(fabric, slot_ids[:b], sels[:b])
    vals_b = vals.expand(b, n + 1).contiguous()
    got = fs.fabric_sweep_batch(vals_b, src, sel_b)
    want = fs.fabric_sweep_batch_plain(vals_b, src, sel_b)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"fabric_sweep_batch differs (max {err})")
    b_ms, b_by = bound(sweep_bytes(src, sel_b), b * n)
    old = torch.empty_like(want)
    f = a.max_fanin

    def launch_earlier():
        build.check(earlier["fabric_sweep_batch"](
            vals_b.data_ptr(), src.data_ptr(), sel_b.data_ptr(),
            old.data_ptr(), b, n, f, n + 1, build.stream_ptr(device)),
            "earlier fabric_sweep_batch")
    rows.append({
        "name": "fabric_sweep_batch", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fabric_sweep.cu",
        "replaces": "src/repro/kernels/fabric_step.py:191",
        "max_abs_err": err,
        **timings(lambda: fs.fabric_sweep_batch(vals_b, src, sel_b),
                  lambda: fs.fabric_sweep_batch_plain(vals_b, src, sel_b),
                  reps=5, plain_reps=3),
        "earlier_ms": earlier_ms("fabric_sweep_batch", launch_earlier, old,
                                 want, reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"B": b, "N": n, "F": f,
                  "tiles": dict(zip(("TN", "lanes", "BB", "grid_y",
                                     "smem"),
                                    fs.sweep_batch_tiles(b, n, f)))}})
    return rows


def hpwl_row(routed, device, earlier):
    """The routed apps' placed-net tables (main path's shapes), each held
    to the plain version; times on the largest and at the design
    shape."""
    from repro_torch.kernels import hpwl

    tables = [pin_table(r) for r in routed.values()]
    for pins, mask in tables:
        p_t = torch.as_tensor(pins, device=device)
        m_t = torch.as_tensor(mask, device=device)
        got = hpwl.hpwl(p_t, m_t)
        want = hpwl.hpwl_plain(p_t, m_t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("hpwl differs")
    return box_row("hpwl", "src/repro/kernels/hpwl.py:80",
                   max(tables, key=lambda t: t[1].size), earlier, device)


# ------------------------------------------------------------ the LM paths
def lm_configs():
    """name -> the config ``lm_score`` and ``lm_serve`` run (FULL, its
    depth cut where ``LM_DEPTHS`` says)."""
    from repro_torch.configs import get_config

    configs = {}
    for name, depth in LM_DEPTHS.items():
        cfg = get_config(name)
        if depth is not None:
            log(f"{name}: depth cut from {cfg.num_layers} to {depth} "
                f"layers, full width")
            cfg = cfg.replace(num_layers=depth)
        configs[name] = cfg
    return configs


def lm_model(cfg, device, seed=0):
    """The model with ``attn_impl="kernel"``, random weights drawn on
    ``device`` from ``seed``, and the same weights (no copy) under
    ``attn_impl="plain"``."""
    from repro_torch.models import build_model

    model = build_model(cfg.replace(attn_impl="kernel"), device)
    model.init_params(torch.Generator(device).manual_seed(seed))
    plain = build_model(cfg.replace(attn_impl="plain"), "meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    return model, plain


def lm_tokens(cfg, batch, seq, device, seed=1):
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(3, cfg.vocab_size - 1, (batch, seq), generator=g,
                         device=device)


def lm_extra(cfg, batch, device, seed=2):
    """The inputs a family takes beside its tokens, random from ``seed``
    at the reference tests' scale (0.1): InternVL2's patch embeddings,
    Whisper's frame embeddings."""
    g = torch.Generator(device).manual_seed(seed)
    shape = {"patches": None if cfg.vlm is None
             else (batch, cfg.vlm.num_patches, cfg.vlm.d_patch),
             "frames": None if cfg.encdec is None
             else (batch, cfg.encdec.encoder_seq, cfg.encdec.d_frame)}
    return {k: (0.1 * torch.randn(v, generator=g, device=device))
            .to(cfg.adtype) for k, v in shape.items() if v is not None}


def lm_inputs(cfg, batch, seq, device):
    return {"tokens": lm_tokens(cfg, batch, seq, device),
            **lm_extra(cfg, batch, device)}


def leaky_attention(q, k, v, causal=True):
    """A wrong ``flash_attention_gqa``: its causal mask is off by one, so
    each query also sees the key after it (``lm_score``'s control)."""
    hq, hkv, s, d = q.shape[1], k.shape[1], q.shape[2], q.shape[3]
    k, v = (t.repeat_interleave(hq // hkv, 1).float() for t in (k, v))
    scores = (q.float() / d ** 0.5) @ k.transpose(-1, -2)
    i = torch.arange(s, device=q.device)
    scores.masked_fill_(i[None, :] > i[:, None] + 1, float("-inf"))
    return (scores.softmax(-1) @ v).to(q.dtype)


def carry_dropped_ssd(x, dt, a, b, c, chunk=128):
    """A wrong ``ssd_scan``: every chunk starts from a zero state, as if
    the carry between chunks were lost (``lm_score``'s control)."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain

    return torch.cat([ssd_scan_plain(x[:, i:i + chunk], dt[:, i:i + chunk],
                                     a, b[:, i:i + chunk], c[:, i:i + chunk],
                                     chunk)
                      for i in range(0, x.shape[1], chunk)], dim=1)


def kernel_swaps(cfg):
    """The module attribute through which ``cfg``'s family reaches its
    kernel, and what ``lm_score`` puts there in its place: the kernel's
    plain version (the witness) and a wrong function (the control);
    ``None`` for a family that reaches no kernel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd

    kernel = FAMILY_KERNEL[cfg.family]
    if kernel == "flash_attention":
        return fa, "flash_attention_gqa", {
            "witness": fa.flash_attention_gqa_plain,
            "control": leaky_attention}
    if kernel == "ssd_scan":
        return ssd, "ssd_scan", {"witness": ssd.ssd_scan_plain,
                                 "control": carry_dropped_ssd}
    return None


def recording(routes):
    """``moe_route`` that appends each MoE layer's expert choices to
    ``routes``, in call order."""
    from repro_torch.models import layers as L

    route = L.moe_route

    def rec(p, xf, cfg):
        weights, experts = route(p, xf, cfg)
        routes.append(experts)
        return weights, experts
    return rec


def replaying(routes, flips):
    """``moe_route`` that takes each MoE layer's experts from ``routes``
    (the kernel path's, in call order) with this path's own gates at
    them, renormalised; ``flips`` counts the tokens whose own top k
    would have been another set."""
    from repro_torch.models import layers as L

    route, calls = L.moe_route, iter(routes)

    def rep(p, xf, cfg):
        experts = next(calls)
        _, own = route(p, xf, cfg)
        flips[0] += int((own.sort(-1).values != experts.sort(-1).values)
                        .any(-1).sum())
        flips[1] += own[..., 0].numel()
        gates = torch.softmax(xf.float() @ p.router, dim=-1)
        weights = torch.gather(gates, -1, experts)
        return weights / weights.sum(-1, keepdim=True).clamp_min(1e-9), \
            experts
    return rep


@contextlib.contextmanager
def swapped(module, attr, fn):
    saved = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, saved)


def logit_gap(got, want):
    """How far ``got`` logits are from ``want``: the largest |difference|
    over the largest |want|, the largest per-position relative error
    ||got_t - want_t|| / ||want_t||, and the share of positions whose
    argmax agrees."""
    got, want = got.float(), want.float()
    rows = (got - want).norm(dim=-1) / want.norm(dim=-1)
    return {"rel_err": float((got - want).abs().max() / want.abs().max()),
            "row_rel_err": float(rows.max()),
            "argmax_agree": float((got.argmax(-1) == want.argmax(-1))
                                  .float().mean())}


def passes(gap):
    return (gap["rel_err"] <= LM_TOL and gap["row_rel_err"] <= LM_ROW_TOL
            and gap["argmax_agree"] >= LM_ARGMAX)


def cpu_check(name, cfg, device):
    """A kernel-free family's card logits held to the port's CPU path on
    the same weights: full width, the depth ``CPU_CHECK`` cuts to, in
    float32 (drawn on the card, copied to the CPU)."""
    from repro_torch.models import build_model

    cut = CPU_CHECK[name](cfg).replace(param_dtype="float32",
                                       activation_dtype="float32")
    card, _ = lm_model(cut, device, seed=3)
    host = build_model(cut, "cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = lm_inputs(cut, CPU_CHECK_BATCH, CPU_CHECK_SEQ, device)
    with torch.inference_mode():
        got = card.logits(batch).cpu()
        want = host.logits({k: v.cpu() for k, v in batch.items()})
    del card, host
    torch.cuda.empty_cache()
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= CPU_CHECK_TOL:
        raise AssertionError(f"{name}: card logits {err} of the largest "
                             f"from the CPU's (float32, {cut.num_layers} "
                             f"layers)")
    return {"layers": cut.num_layers,
            "encoder_layers": cut.encdec and cut.encdec.encoder_layers,
            "batch": CPU_CHECK_BATCH, "seq": CPU_CHECK_SEQ,
            "dtype": "float32", "rel_err": err}


def lm_score_phase(name, model, plain, device, batch, seq, controls=True):
    """``logits`` of one model on the kernel path and the plain path:
    finite, of shape (B, S, padded vocab), within the ``LM_*`` gate. Two
    more forwards of the kernel path hold the gate to account: with the
    kernel's plain version in its place (the witness) the logits must
    pass it too, and with a wrong function in its place (the control),
    fail it. A kernel-free family has no witness or control: its card
    logits are held to the CPU instead (``cpu_check``). With ``controls``
    False (the smoke configs of ``lm_smoke_kernels``) the kernel path is
    held to the plain path alone.

    An MoE model's expert choice is a top k: where two gates nearly tie,
    the last bf16 ulp of the attention picks the expert, and the chosen
    expert moves that token's logits by far more than the gate allows.
    So the plain, witness and control runs replay the kernel path's
    expert choices (``moe_route``) with their own gates; ``route_flips``
    counts the tokens (summed over the MoE layers) whose own choice
    would have differed on the plain run."""
    from repro_torch.models import layers as L

    cfg = model.cfg
    inputs = lm_inputs(cfg, batch, seq, device)
    rec, logits = {"layers": cfg.num_layers}, {}
    routes = [] if cfg.moe is not None and cfg.moe.num_experts else None
    flips = [0, 0]

    def routing(impl):
        if routes is None:
            return contextlib.nullcontext()
        if impl == "kernel":
            return swapped(L, "moe_route", recording(routes))
        return swapped(L, "moe_route", replaying(
            routes, flips if impl == "plain" else [0, 0]))

    with torch.inference_mode():
        for impl, m in (("kernel", model), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with routing(impl):
                got = m.logits(inputs)
            torch.cuda.synchronize()
            rec[f"{impl}_s"] = time.perf_counter() - t0
            if tuple(got.shape) != (batch, seq, cfg.padded_vocab):
                raise AssertionError(f"{name} {impl}: logits shape "
                                     f"{tuple(got.shape)}")
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {impl}: logits not finite")
            logits[impl] = got
        gaps = {"plain": logit_gap(logits["kernel"], logits["plain"])}
        if routes is not None:
            rec["route_flips"], rec["route_tokens"] = flips
        swaps = kernel_swaps(cfg) if controls else None
        if swaps is not None:
            module, attr, fns = swaps
            for label, fn in fns.items():
                with swapped(module, attr, fn), routing(label):
                    got = model.logits(inputs)
                gaps[label] = (logit_gap(logits["kernel"], got)
                               if label == "witness"
                               else logit_gap(got, logits["plain"]))
        plain_top = int(logits["plain"].argmax(-1).unique().numel())
    del logits, got
    log(f"lm_score {name}: {gaps}, {plain_top} distinct argmax tokens"
        + (f", {flips[0]} of {flips[1]} routed tokens would flip"
           if routes is not None else ""))
    for label, gap in gaps.items():
        if passes(gap) == (label == "control"):
            raise AssertionError(f"{name}: the gate misjudges the "
                                 f"{label} logits: {gap}")
    if controls and name in CPU_CHECK:
        rec["cpu_check"] = cpu_check(name, cfg, device)
        log(f"lm_score {name}: card against CPU {rec['cpu_check']}")
    return {**rec, "gaps": gaps, "plain_argmax_tokens": plain_top,
            "batch": batch, "seq": seq,
            "tokens_per_s": batch * seq / rec["kernel_s"]}


class CheckedModel:
    """A model whose prefill and decode steps record whether every logit
    they returned was finite."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.finite = True

    def init_cache(self, batch, max_seq):
        return self.model.init_cache(batch, max_seq)

    def _checked(self, out):
        self.finite &= bool(torch.isfinite(out[0]).all())
        return out

    def prefill(self, cache, batch):
        return self._checked(self.model.prefill(cache, batch))

    def decode_step(self, cache, batch):
        return self._checked(self.model.decode_step(cache, batch))


def lm_serve_phase(name, model, serve):
    """``ServeEngine.generate`` twice on the same prompts (InternVL2 with
    its patches, Whisper with its frames, as ``extra_inputs``)."""
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serve import ServeEngine

    checked = CheckedModel(model)
    max_seq = SERVE_MAX_SEQ.get(model.cfg.family, serve["max_seq"])
    engine = ServeEngine(checked, batch_size=serve["batch"],
                         max_seq=max_seq)
    prompts = make_prompts(model.cfg.vocab_size, serve["requests"])
    extra = lm_extra(model.cfg, serve["batch"], model.device) or None
    runs, seconds = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(engine.generate(prompts, max_new_tokens=serve["max_new"],
                                    extra_inputs=extra))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    first, second = runs
    if len(first) != len(prompts) or not all(first):
        raise AssertionError(f"{name}: a request got no token")
    if first != second:
        raise AssertionError(f"{name}: a second generate differs")
    if not checked.finite:
        raise AssertionError(f"{name}: non-finite serving logits")
    n_tok = sum(len(o) for o in second)
    return {"requests": len(prompts), "tokens": n_tok, "max_seq": max_seq,
            "seconds": seconds, "tokens_per_s": n_tok / seconds[1],
            "first_tokens": first[0][:8]}


def config_overrides(arch, overrides):
    """``overrides`` as ``ModelConfig.replace`` takes them: a
    ``num_experts`` cut becomes the arch's MoE config with that many."""
    from repro_torch.configs import get_config

    overrides = dict(overrides)
    if "num_experts" in overrides:
        overrides["moe"] = dataclasses.replace(
            get_config(arch).moe, num_experts=overrides.pop("num_experts"))
    return overrides


def train_config(arch, overrides):
    from repro_torch.configs import get_config

    return get_config(arch).replace(**config_overrides(arch, overrides))


def train_run(device, arch, batch, microbatches, steps, lr,
              optimizer="adamw", overrides=None):
    """One throughput run of ``launch.train.train`` at FULL (its config
    ``overrides`` applied; a VLM's stub patches and Whisper's stub frames
    join every batch); its record and whether its loss fell by
    ``TRAIN_DROP`` (the lowest of the last half of the steps against the
    first). MFU counts an MoE model's active parameters, as the roofline
    model does."""
    from repro_torch.launch.train import train
    from repro_torch.roofline.analysis import (active_params, count_params,
                                               model_flops)
    from repro_torch.roofline.hw import H100_SXM

    overrides = config_overrides(arch, overrides or {})
    extra = lm_extra(train_config(arch, overrides), batch, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    out = train(arch=arch, steps=steps, seq=TRAIN_SEQ, batch=batch,
                microbatches=microbatches, device=device, lr=lr, warmup=1,
                ckpt_every=steps + 1, optimizer=optimizer,
                overrides=overrides, extra_inputs=extra)
    hist = [h for h in out["history"] if h["event"] == "step"]
    losses = [h["metrics"]["loss"] for h in hist]
    norms = [h["metrics"]["grad_norm"] for h in hist]
    if len(hist) != steps or not np.isfinite(losses + norms).all():
        raise AssertionError(f"train {arch} lr {lr}: losses {losses}, "
                             f"gradient norms {norms}")
    seconds = [h["seconds"] for h in hist]
    step_s = float(np.median(seconds[1:]))
    tokens = batch * TRAIN_SEQ
    cfg = out["config"]
    n_params = count_params(out["model"])
    n_active = active_params(cfg, n_params)
    drop = (losses[0] - min(losses[steps // 2:])) / abs(losses[0])
    rec = {"steps": steps, "batch": batch, "seq": TRAIN_SEQ,
           "microbatches": microbatches, "remat": cfg.remat,
           "optimizer": optimizer, "layers": cfg.num_layers,
           "experts": cfg.moe.num_experts if cfg.moe else None,
           "extra_inputs": {k: list(v.shape) for k, v in extra.items()},
           "lr": lr, "params": n_params, "active_params": n_active,
           "losses": losses, "grad_norms": norms, "loss_drop": drop,
           "step_seconds": seconds, "step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "max_memory_bytes": torch.cuda.max_memory_allocated(device),
           "mfu": model_flops(n_active, tokens, "train")
           / (step_s * H100_SXM.peak_flops_bf16)}
    del out
    torch.cuda.empty_cache()
    return rec, drop >= TRAIN_DROP


def restart_leg(device):
    """Fail at step 3, restore step 2, finish: equal to an uninterrupted
    run bit for bit; a save then restore of the end state, too."""
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_items

    kw = dict(arch="tinyllama-1.1b", steps=RESTART_STEPS, seq=TRAIN_SEQ,
              batch=RESTART_BATCH, device=device, optimizer="adafactor",
              lr=TRAIN_LR, warmup=1, overrides={"num_layers": 2})
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        plain = train(ckpt_every=RESTART_STEPS + 1, **kw)
        hurt = train(ckpt_every=RESTART_EVERY, fail_at=(RESTART_FAIL,),
                     **kw)
    finally:
        torch.use_deterministic_algorithms(was)
    events = [(h["event"], h.get("step", h.get("at_step")))
              for h in hurt["history"]]
    want = ([("step", i) for i in range(RESTART_FAIL)]
            + [("restart", RESTART_EVERY)]
            + [("step", i) for i in range(RESTART_EVERY, RESTART_STEPS)])
    if events != want:
        raise AssertionError(f"restart: events {events} != {want}")
    state = hurt["state"]
    mine, other = dict(tree_items(state)), dict(tree_items(plain["state"]))
    differ = [k for k in mine if not torch.equal(mine[k], other[k])]
    if differ:
        raise AssertionError(f"restart: the restored run ends apart from "
                             f"the uninterrupted one at {differ[:5]}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(RESTART_STEPS, state, blocking=True)
        save_s = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(root, f))
                         for root, _, files in os.walk(d) for f in files)
        t0 = time.perf_counter()
        back = dict(tree_items(mgr.restore(RESTART_STEPS, like=state)))
        restore_s = time.perf_counter() - t0
    differ = [k for k in mine if back[k].dtype != mine[k].dtype
              or not torch.equal(back[k], mine[k])]
    if differ:
        raise AssertionError(f"restart: save/restore changed {differ[:5]}")
    losses = [h["metrics"]["loss"] for h in hurt["history"]
              if h["event"] == "step"]
    return {"steps": RESTART_STEPS, "batch": RESTART_BATCH,
            "seq": TRAIN_SEQ, "layers": 2, "optimizer": "adafactor",
            "events": events, "losses": losses, "leaves": len(mine),
            "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
            "restore_s": restore_s, "equal": True}


def train_phase(device):
    """Phase 12: the FULL models' training steps (each with its rate-0
    control) and the restart leg."""
    runs = {}
    for arch, batch, microbatches, steps, optimizer, lr, overrides in \
            TRAIN_RUNS:
        full = train_config(arch, {})
        cut = {k: [full_n, overrides[o]] for k, o, full_n in (
            ("layers", "num_layers", full.num_layers),
            ("experts", "num_experts", full.moe and full.moe.num_experts))
            if o in overrides}
        if cut:
            log(f"train {arch}: cut (full width) "
                + ", ".join(f"{k} from {a} to {b}"
                            for k, (a, b) in cut.items()))
        rec, falls = train_run(device, arch, batch, microbatches, steps, lr,
                               optimizer, overrides)
        control, control_falls = train_run(device, arch, batch,
                                           microbatches, steps, 0.0,
                                           optimizer, overrides)
        log(f"train {arch}: batch {batch} x {TRAIN_SEQ} in "
            f"{max(microbatches, 1)} microbatch(es), {optimizer}, remat "
            f"{rec['remat']}; {rec['step_s']:.3f} s/step, "
            f"{rec['tokens_per_s']:.0f} tokens/s, mfu {rec['mfu']:.3f}, "
            f"peak {rec['max_memory_bytes'] / 1e9:.1f} GB, losses "
            f"{rec['losses']}; control {control['losses']}")
        if not falls:
            raise AssertionError(f"train {arch}: the loss fell "
                                 f"{rec['loss_drop']:.4f} < {TRAIN_DROP}")
        if control_falls:
            raise AssertionError(f"train {arch}: the loss check passes "
                                 f"the rate-0 control")
        rec["control"] = {k: control[k] for k in ("losses", "loss_drop",
                                                  "step_s")}
        if cut:
            rec["cut"] = cut
        runs[arch] = rec
    return {"runs": runs, "restart": restart_leg(device)}


def row_control(name, bad, want, **tol):
    """A kernel row's check must reject ``bad``, the output of the wrong
    function that ``lm_score`` uses as its control."""
    err = float((bad.float() - want.float()).abs().max())
    if torch.allclose(bad.float(), want.float(), **tol):
        raise AssertionError(f"{name}: the row check passes its control")
    log(f"{name} row: the control differs by {err}")


def flash_row(device, b=LM_BATCH, hq=32, hkv=4, s=LM_SEQ, d=64):
    """``flash_attention`` at TinyLlama's shape on the LM path, bf16,
    with the same measurements at ``FLASH_SHAPES`` under ``shapes``."""
    row = flash_shape(device, b, hq, hkv, s, d)
    row["shapes"] = [flash_shape(device, b, h, kv, s, dd, dt)
                     for h, kv, dd, dt in FLASH_SHAPES]
    return row


#: |got - want| <= atol + rtol |want| of a 16-bit flash output: one ulp
FLASH_TOL = {"bfloat16": dict(atol=FLASH_ATOL, rtol=FLASH_RTOL),
             "float16": dict(atol=FLASH_ATOL, rtol=2.0 ** -10)}


def flash_shape(device, b, hq, hkv, s, d, dtype="bfloat16"):
    """One shape of the ``flash_attention`` row: held to the plain
    version, its control rejected, timed beside the plain version and
    SDPA, with its bound."""
    from repro_torch.kernels import flash_attention as fa

    tdt, tol = getattr(torch, dtype), FLASH_TOL[dtype]
    g = torch.Generator(device).manual_seed(5)
    q = torch.randn((b, hq, s, d), generator=g, device=device).to(tdt)
    k = torch.randn((b, hkv, s, d), generator=g, device=device).to(tdt)
    v = torch.randn((b, hkv, s, d), generator=g, device=device).to(tdt)
    got = fa.flash_attention_gqa(q, k, v, causal=True)
    want = fa.flash_attention_gqa_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"flash_attention (D {d}, {dtype}) differs "
                             f"by {err}")
    bad = leaky_attention(q, k, v)
    row_control(f"flash_attention (D {d}, {dtype})", bad, want, **tol)
    control_err = float((bad.float() - want.float()).abs().max())
    del bad
    pairs = s * (s + 1) // 2                    # causal (q, k) pairs
    flops = 4 * b * hq * d * pairs              # the function's 4 D a pair
    b_ms, b_by = bound(nbytes(q, k, v, got), flops, TENSOR_BF16_FLOPS_PER_S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times = timings(lambda: fa.flash_attention_gqa(q, k, v, causal=True),
                    lambda: fa.flash_attention_gqa_plain(q, k, v,
                                                         causal=True),
                    reps=10, plain_reps=5)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:94",
            "max_abs_err": err, **times,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": graph_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                enable_gqa=True), 10),
            "tflops": flops / (times["ms"] * 1e-3) / 1e12,
            "control_err": control_err,
            "plan": fa.plan(d, tdt)._asdict(),
            "shape": {"B": b, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                      "dtype": dtype, "causal": True}}


def ssd_row(device, earlier, bh=LM_BATCH * 64, seq=LM_SEQ, p=64, n=128,
            chunk=128):
    """``ssd_scan`` at Mamba2-1.3B's shape on the LM path, float32, with
    the reference test's input ranges, beside ``earlier`` (its kernel
    before the redesign); the same measurements at ``SSD_SHAPES`` under
    ``shapes``."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as ssd

    row, (x, dt, a, b, c), want = ssd_shape(device, bh, seq, p, n, chunk)
    old = torch.empty_like(want)

    def launch_earlier():
        build.check(earlier(*(t.data_ptr() for t in (x, dt, a, b, c, old)),
                            bh, seq, p, n, chunk, build.stream_ptr(device)),
                    "earlier ssd_scan")
    row["earlier_ms"] = earlier_ms("ssd_scan", launch_earlier, old, want,
                                   reps=10, atol=SSD_TOL, rtol=SSD_TOL)
    del x, dt, a, b, c, want, old
    row["shapes"] = [ssd_shape(device, *shape)[0] for shape in SSD_SHAPES]
    return row


def ssd_shape(device, bh, seq, p, n, chunk):
    """One shape of the ``ssd_scan`` row, held to the plain version, its
    control rejected, timed beside it, with its bound; also its inputs
    and the plain output."""
    from repro_torch.kernels import ssd_scan as ssd

    g = torch.Generator(device).manual_seed(6)
    x = torch.randn((bh, seq, p), generator=g, device=device)
    dt = 0.1 + 0.5 * torch.rand((bh, seq), generator=g, device=device)
    a = -0.5 - torch.rand((bh,), generator=g, device=device)
    b = 0.3 * torch.randn((bh, seq, n), generator=g, device=device)
    c = 0.3 * torch.randn((bh, seq, n), generator=g, device=device)
    got = ssd.ssd_scan(x, dt, a, b, c, chunk=chunk)
    want = ssd.ssd_scan_plain(x, dt, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=SSD_TOL, rtol=SSD_TOL):
        raise AssertionError(f"ssd_scan {(chunk, p, n)} differs by {err}")
    row_control(f"ssd_scan {(chunk, p, n)}",
                carry_dropped_ssd(x, dt, a, b, c, chunk), want,
                atol=SSD_TOL, rtol=SSD_TOL)
    lens = [min(chunk, seq - s0) for s0 in range(0, seq, chunk)]
    # per bh: c.b^T and w.x over each chunk's causal (t, u) pairs; c.h0^T
    # for every chunk after the first (h0 = 0 before it) and the state
    # update for every chunk before the last (nothing reads the final
    # state), 2 flops a multiply-add
    flops = (sum(cl * (cl + 1) * (n + p) for cl in lens)
             + 2 * n * p * (sum(lens[1:]) + sum(lens[:-1])))
    b_ms, b_by = bound(nbytes(x, dt, a, b, c, got), bh * flops)
    row = {"name": "ssd_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
           "replaces": "src/repro/kernels/ssd_scan.py:96",
           "max_abs_err": err,
           **timings(lambda: ssd.ssd_scan(x, dt, a, b, c, chunk=chunk),
                     lambda: ssd.ssd_scan_plain(x, dt, a, b, c,
                                                chunk=chunk),
                     reps=10, plain_reps=5),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "plan": ssd.plan(chunk, p, n)._asdict(),
           "shape": {"BH": bh, "L": seq, "P": p, "N": n, "chunk": chunk,
                     "dtype": "float32"}}
    return row, (x, dt, a, b, c), want


def lm_paths(phase, device, configs, batch=LM_BATCH, seq=LM_SEQ,
             serve=SERVE):
    """The two LM phases on ``configs`` (name -> ModelConfig), one model
    at a time: build, score (``lm_score:<name>``), serve
    (``lm_serve:<name>``), free. Each phase must launch its family's
    kernel once a layer, and serving none; the peak of
    ``max_memory_allocated`` is the model's, build to free."""
    score, served = {}, {}
    for name, cfg in configs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        model, plain = lm_model(cfg, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        with torch.inference_mode():      # first-call set-up, off the clock
            warm = lm_inputs(cfg, 1, 128, device)
            model.logits(warm)
            plain.logits(warm)
        kernel = FAMILY_KERNEL[cfg.family]
        need = (kernel,) if kernel else ()
        score[name] = phase(f"lm_score:{name}", lm_score_phase, name, model,
                            plain, device, batch, seq, need=need)
        served[name] = phase(f"lm_serve:{name}", lm_serve_phase, name,
                             model, serve, need=())
        score[name]["build_s"] = build_s
        score[name]["max_memory_bytes"] = torch.cuda.max_memory_allocated(
            device)
        score[name]["params"] = sum(p.numel() for p in model.parameters())
        del model, plain
        torch.cuda.empty_cache()
    return score, served


def lm_smoke_kernels(phase, device):
    """Each ``LM_SMOKE`` config's kernel path on the card (its own phase
    ``lm_smoke_kernels:<arch>``): ``logits`` with ``attn_impl="kernel"``
    at B 2 x S 96, held to the plain path by the ``LM_*`` gate, launching
    its family's kernel exactly once a layer."""
    from repro_torch.configs import get_smoke

    out = {}
    for name in LM_SMOKE:
        cfg = get_smoke(name)
        kernel = FAMILY_KERNEL[cfg.family]
        model, plain = lm_model(cfg, device)
        rec = phase(f"lm_smoke_kernels:{name}", lm_score_phase, name, model,
                    plain, device, LM_SMOKE_BATCH, LM_SMOKE_SEQ, False,
                    need=(kernel,))
        out[name] = {**rec, "kernel": kernel, "layers": cfg.num_layers,
                     "head_dim": (cfg.head_dim or cfg.d_model
                                  // cfg.num_heads) if cfg.num_heads
                     else None,
                     "ssd": cfg.ssm and [cfg.ssm.chunk, cfg.ssm.head_dim,
                                         cfg.ssm.state_dim]}
        del model, plain
    return out


def examples_phase(device):
    """The port's four examples (``examples/torch_*.py``) on the card at
    their default sizes (the DSE example's store in a temporary
    directory), each asserting its own result; their printed lines'
    count and seconds."""
    import importlib.util
    import io
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory(prefix="canal_torch_store_") as store:
        for name, argv in (("torch_quickstart", []),
                           ("torch_serve_lm", []),
                           ("torch_train_tinylm", []),
                           ("torch_cgra_dse", ["--store", store])):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join(ROOT, "examples", f"{name}.py"))
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                module.main(argv)
            torch.cuda.synchronize()
            text = buf.getvalue().splitlines()
            if not text or text[-1] != "OK":
                raise AssertionError(f"example {name}: {text[-5:]}")
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "lines": len(text), "last": text[-2]}
            log(f"example {name}: {runs[name]}")
    return runs


#: the dry run's FULL cells on the fake production meshes: (arch, shape,
#: mesh, attn_impl)
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k", "single", None),
                ("qwen3-14b", "prefill_32k", "single", "kernel"),
                ("mamba2-1.3b", "long_500k", "single", None),
                ("kimi-k2-1t-a32b", "decode_32k", "multi", None))
#: the two programs counted on the card and in the fake at one rank:
#: TinyLlama's step of the ``train`` phase and Qwen3's kernel-path
#: ``lm_score`` forward, and the flash launches the latter makes
DRYRUN_STEP = dict(arch="tinyllama-1.1b", batch=8, seq=TRAIN_SEQ,
                   microbatches=4)
DRYRUN_FWD = dict(arch="qwen3-14b", batch=LM_BATCH, seq=LM_SEQ, launches=40)
#: predicted peak over ``max_memory_allocated``, and the most useful FLOPs
#: a cell may claim over those it counts
DRYRUN_MEM_GATE, DRYRUN_USEFUL_MAX = (0.75, 1.25), 1.05
#: the fake traces run in child processes (their own fake process
#: groups, away from this process's CUDA state), three side by side: two
#: cells each, and the one-rank traces; each prints one JSON line
DRYRUN_CHILD = """
import json, sys, tempfile
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
cells, step, fwd = json.loads(sys.argv[1])
out = {"cells": []}
with tempfile.TemporaryDirectory(prefix="dryrun_torch_") as d:
    for arch, shape, mesh, impl in cells:
        out["cells"].append(dryrun.run_cell(arch, shape, mesh, out_dir=d,
                                            attn_impl=impl))
if step:
    out["train"] = dryrun.trace_one_rank(
        "train", get_config(step["arch"]).replace(ce_seq_chunk=512),
        step["batch"], step["seq"], step["microbatches"])
    out["logits"] = dryrun.trace_one_rank(
        "logits", get_config(fwd["arch"]).replace(attn_impl="kernel"),
        fwd["batch"], fwd["seq"])
print(json.dumps(out))
"""
#: the cells of each child (the one-rank traces run in a third)
DRYRUN_SPLIT = ((0, 2), (1, 3))


def dryrun_cell_line(rec):
    """One cell's figures, checked: it fails on a term of 0 or a useful
    FLOP ratio over ``DRYRUN_USEFUL_MAX``."""
    mem, terms = rec["memory_analysis"], rec["roofline"]
    row = {"cell": f"{rec['arch']} x {rec['shape']} x {rec['mesh']}",
           "ranks": rec["n_devices"],
           "argument_gb": mem["argument_size_in_bytes"] / 1e9,
           "temp_gb": mem["temp_size_in_bytes"] / 1e9, "fits": rec["fits"],
           "flops": rec["per_device_flops"],
           "hbm_bytes": rec["per_device_hbm_bytes"],
           "link_bytes": rec["per_chip_link_bytes"],
           "collectives": rec["collectives"]["count"],
           "compute_s": terms["compute_s"], "memory_s": terms["memory_s"],
           "collective_s": terms["collective_s"],
           "dominant": terms["dominant"],
           "useful_flops_ratio": rec["useful_flops_ratio"],
           "trace_seconds": rec["trace_seconds"]}
    zero = [k for k in ("flops", "hbm_bytes", "link_bytes", "compute_s",
                        "memory_s", "collective_s") if not row[k] > 0]
    if zero:
        raise AssertionError(f"dryrun {row['cell']}: zero {zero}")
    if row["useful_flops_ratio"] > DRYRUN_USEFUL_MAX:
        raise AssertionError(f"dryrun {row['cell']}: useful FLOPs ratio "
                             f"{row['useful_flops_ratio']:.3f} > "
                             f"{DRYRUN_USEFUL_MAX}")
    log(f"dryrun {row['cell']}: args {row['argument_gb']:.2f} GB, temp "
        f"{row['temp_gb']:.2f} GB a rank (fits 80 GB: {row['fits']}), "
        f"{row['flops']:.3e} FLOPs, {row['hbm_bytes']:.3e} HBM bytes, "
        f"{row['link_bytes']:.3e} link bytes, {row['collectives']} "
        f"collectives; H100 roofline compute {row['compute_s']:.4f} s, "
        f"memory {row['memory_s']:.4f} s, collective "
        f"{row['collective_s']:.4f} s: {row['dominant']}; useful "
        f"{row['useful_flops_ratio']:.3f}; traced in "
        f"{row['trace_seconds']:.1f} s")
    return row


def card_count(run, args, no_grad, device):
    """``run`` counted on the card (``roofline/cost.py``) with its
    ``max_memory_allocated``, then timed: its best of three runs,
    synchronized."""
    from repro_torch.launch import dryrun

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    counter, out, _, arg_bytes = dryrun.count(run, args, no_grad)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    del out
    card = dryrun.summary(counter, 0.0, arg_bytes)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad() if no_grad else contextlib.nullcontext():
            out = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del out
    return {**card, "max_memory_allocated": peak, "step_s": min(times)}


def card_vs_fake(name, card, fake):
    """The card's count against the fake's: FLOPs, bytes and op count
    equal, the fake's peak within ``DRYRUN_MEM_GATE`` of
    ``max_memory_allocated``; the time beside the H100 roofline bound."""
    from repro_torch.roofline.analysis import roofline_terms
    from repro_torch.roofline.hw import H100_SXM

    same = {k: card[k] == fake[k] for k in ("flops", "bytes", "n_ops")}
    if not all(same.values()):
        diff = {op: (card["ops"].get(op, 0), fake["ops"].get(op, 0))
                for op in set(card["ops"]) | set(fake["ops"])
                if card["ops"].get(op, 0) != fake["ops"].get(op, 0)}
        raise AssertionError(f"dryrun {name}: the card's count differs from "
                             f"the fake's: {same}; card {card['flops']} "
                             f"FLOPs {card['bytes']} bytes {card['n_ops']} "
                             f"ops, fake {fake['flops']} {fake['bytes']} "
                             f"{fake['n_ops']}; ops (card, fake) {diff}")
    peak = card["max_memory_allocated"]
    ratio = fake["peak_bytes"] / peak
    if not DRYRUN_MEM_GATE[0] <= ratio <= DRYRUN_MEM_GATE[1]:
        raise AssertionError(f"dryrun {name}: predicted peak "
                             f"{fake['peak_bytes']} over the card's {peak}"
                             f" = {ratio:.3f}, outside {DRYRUN_MEM_GATE}")
    terms = roofline_terms(card["flops"], card["bytes"], 0.0,
                           chip=H100_SXM)
    step_s = card["step_s"]
    rec = {"flops": card["flops"], "bytes": card["bytes"],
           "n_ops": card["n_ops"], "predicted_peak_bytes":
           fake["peak_bytes"], "max_memory_allocated": peak,
           "peak_ratio": ratio, "card_counter_peak_bytes":
           card["peak_bytes"], "step_s": step_s,
           "bound_s": terms["bound_s"], "dominant": terms["dominant"],
           "roofline_fraction": terms["bound_s"] / step_s,
           "fake_trace_s": fake["seconds"]}
    log(f"dryrun {name}: card = fake: {card['flops']:.4e} FLOPs, "
        f"{card['bytes']:.4e} bytes, {card['n_ops']} ops; peak predicted "
        f"{fake['peak_bytes'] / 1e9:.2f} GB, card "
        f"{peak / 1e9:.2f} GB ({ratio:.3f}); {step_s:.4f} s against "
        f"the H100 bound {terms['bound_s']:.4f} s ({terms['dominant']}): "
        f"roofline fraction {rec['roofline_fraction']:.3f}")
    return rec


def sharded_step_check(device):
    """The TinyLlama FULL step of ``DRYRUN_STEP`` over a real one-rank
    NCCL mesh (DTensors of the reference's specs) against the unsharded
    step: loss and three parameter leaves bit for bit."""
    import socket
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config(DRYRUN_STEP["arch"]).replace(ce_seq_chunk=512)
    leaves = (("embed",), ("dense_layers", "attn", "wq"), ("ln_f", "scale"))
    args = (cfg, DRYRUN_STEP["batch"], DRYRUN_STEP["seq"],
            DRYRUN_STEP["microbatches"], device, 0)

    def outcome(run):
        state, metrics = run()
        got = []
        for path in leaves:
            t = state.params
            for key in path:
                t = t[key]
            got.append((t.full_tensor() if hasattr(t, "full_tensor")
                        else t).detach().clone())
        loss = metrics["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        return loss.detach().clone(), got

    run, _ = dryrun.train_program(*args)
    want = outcome(run)
    del run
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, "cuda")
        run, _ = dryrun.train_program(*args, mesh=mesh)
        got = outcome(run)
        del run
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    same = [torch.equal(a, b) for a, b in zip([want[0]] + want[1],
                                              [got[0]] + got[1])]
    if not all(same):
        raise AssertionError(f"dryrun: the one-rank NCCL mesh's step is not "
                             f"the unsharded step's: loss {float(want[0])} "
                             f"vs {float(got[0])}, equal {same}")
    log(f"dryrun: the sharded step over a one-rank NCCL mesh equals the "
        f"unsharded step bit for bit (loss {float(want[0])}, leaves "
        f"{['/'.join(p) for p in leaves]})")
    return {"loss": float(want[0]), "leaves": ["/".join(p) for p in leaves],
            "equal": True}


def dryrun_phase(device):
    """Phase 12b: (a) the four FULL cells on the fake production meshes
    and (b) the fake one-rank counts, in three child processes, while on
    the card (b) TinyLlama's step and Qwen3's kernel-path forward are
    counted and timed and (c) the step runs over a one-rank NCCL mesh;
    then the children's counts are held to the card's."""
    import tempfile

    from repro_torch.configs import canonical, get_config
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_child = time.perf_counter()
    parts = [([DRYRUN_CELLS[i] for i in idx], None, None)
             for idx in DRYRUN_SPLIT] + [([], DRYRUN_STEP, DRYRUN_FWD)]
    children = []
    for part in parts:
        # files, not pipes: nothing reads a child while the card works
        files = [tempfile.TemporaryFile("w+") for _ in range(2)]
        children.append((subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, json.dumps(part)],
            cwd=ROOT, env=env, stdout=files[0], stderr=files[1],
            text=True), files))
    try:
        # the card's work first, while the child traces
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        step_cfg = get_config(DRYRUN_STEP["arch"]).replace(ce_seq_chunk=512)
        step = dryrun.train_program(
            step_cfg, DRYRUN_STEP["batch"], DRYRUN_STEP["seq"],
            DRYRUN_STEP["microbatches"], device, seed=0)
        card_step = card_count(*step, False, device)
        del step
        torch.cuda.empty_cache()
        fwd_cfg = get_config(DRYRUN_FWD["arch"]).replace(attn_impl="kernel")
        fwd = dryrun.logits_program(fwd_cfg, DRYRUN_FWD["batch"],
                                    DRYRUN_FWD["seq"], device, seed=0)
        before = build.LAUNCHES["flash_attention"]
        card_fwd = card_count(*fwd, True, device)
        launches = build.LAUNCHES["flash_attention"] - before
        del fwd
        torch.cuda.empty_cache()
        sharded = sharded_step_check(device)
        card_s = time.perf_counter() - t0
        for child, _ in children:
            child.wait(timeout=600)
    finally:
        outs = []
        for child, files in children:
            if child.poll() is None:
                child.kill()
                child.wait()
            for f in files:
                f.seek(0)
            outs.append((child.returncode, files[0].read(), files[1].read()))
            for f in files:
                f.close()
    fake = {"cells": []}
    for rc, out, err in outs:
        if rc != 0:
            raise AssertionError(f"dryrun child failed: {err[-3000:]}")
        part = json.loads(out.strip().splitlines()[-1])
        fake["cells"] += part.pop("cells")
        fake.update(part)
    order = {(canonical(a), sh, m): i for i, (a, sh, m, _) in
             enumerate(DRYRUN_CELLS)}
    fake["cells"].sort(key=lambda r: order[r["arch"], r["shape"],
                                           r["mesh"]])
    cells = [dryrun_cell_line(rec) for rec in fake["cells"]]
    train = card_vs_fake("tinyllama step", card_step, fake["train"])
    logits = card_vs_fake("qwen3 forward", card_fwd, fake["logits"])
    # the counted run and the three timed runs each launch once a layer
    calls = fake["logits"]["ops"].get("canal.flash_attention")
    if launches != 4 * DRYRUN_FWD["launches"] or \
            calls != DRYRUN_FWD["launches"]:
        raise AssertionError(f"dryrun qwen3 forward: {launches} launches "
                             f"in 4 runs, fake custom op calls {calls}, "
                             f"want {DRYRUN_FWD['launches']} a run")
    logits["flash_launches"] = launches // 4
    logits["fake_flash_launches"] = 0
    log(f"dryrun: the card's part {card_s:.1f} s, the children "
        f"{time.perf_counter() - t_child:.1f} s")
    return {"cells": cells, "train_step": train, "qwen3_forward": logits,
            "sharded_step": sharded, "card_seconds": card_s}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.configs.cgra_amber import FULL
    from repro_torch.kernels import build

    # the restart leg runs under torch.use_deterministic_algorithms,
    # which asks for a fixed cuBLAS workspace (set before cuBLAS starts;
    # 32 MiB, the size PyTorch already takes on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build (the earlier kernels beside the library)
    t0 = time.perf_counter()
    procs = start_earlier()
    try:
        build.library()
    finally:
        earlier = finish_earlier(procs)
    log(f"kernel library built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s)")
    drive(FULL, device, t_start, earlier)
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def drive(spec, device, t_start, earlier):
    """Phases 2-13 on ``spec`` and ``device`` (the LM phases on the FULL
    models at B 2, S 2,048), with ``earlier`` the entry points of the
    kernels before their redesign; prints their JSON lines."""
    from repro_torch.kernels import build

    phases = {}

    def phase(name, fn, *args, need=None):
        """Run one path with the launch counts zeroed just before and
        read just after; it must launch every kernel it exists for
        (``need``, else ``PHASE_KERNELS[name]``)."""
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)
        seconds = time.perf_counter() - t0
        need = PHASE_KERNELS[name] if need is None else need
        missing = [k for k in need if launches[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: "
                                 f"{missing} ({launches})")
        phases[name] = {"seconds": seconds,
                        "launches": {k: v for k, v in launches.items()
                                     if v}}
        log(f"{name}: {seconds:.1f} s, launches {phases[name]['launches']}")
        return out

    # 2. main path
    fab, routed, emus, ins, outs, report = phase("main", main_path, spec,
                                                 device)
    report.update(check_main_path(fab, routed, emus, ins, outs, report))
    report["placed_hpwl"] = phase("smoke", hpwl_phase, routed, device)
    # 3.-7. the DSE slice's paths
    results = {
        "emulate": phase("emulate", emulate_phase, fab, routed, ins, outs),
        "verify": phase("verify", verify_phase, fab),
        "serve": phase("serve", serve_phase, spec, fab.area(), device),
        "engines": phase("engines", engines_phase, device),
        "search": phase("search", search_phase, device),
    }
    # 8. the ready-valid fabric at FULL
    results["rv"], rv_cases = phase("rv", rv_phase, spec, device)
    # 8b. the two-layer array: 1-bit nets, the predicate PE layout
    results["two_layer"], pred_fabric = phase("two_layer", two_layer_phase,
                                              device)
    for name, need in (("minplus", "minplus_step"),
                       ("batched", "net_bboxes")):
        if name in results["search"]["strategies"] and \
                not phases["search"]["launches"].get(need):
            raise AssertionError(f"search: {name} ran without {need}")

    # 9.-10. the LM substrate at full width: one kernel launch per layer
    configs = lm_configs()
    score, served = lm_paths(phase, device, configs)
    for name, cfg in configs.items():
        kernel = FAMILY_KERNEL[cfg.family]
        want = {kernel: cfg.num_layers} if kernel else {}
        got = phases[f"lm_score:{name}"]["launches"]
        if got != want:
            raise AssertionError(f"lm_score {name}: launches {got} != "
                                 f"{want}")
        if phases[f"lm_serve:{name}"]["launches"]:
            raise AssertionError(f"lm_serve {name} launched kernels: "
                                 f"{phases[f'lm_serve:{name}']['launches']}")
    # 9b. each smoke config's kernel path: one launch a layer
    smoke = lm_smoke_kernels(phase, device)
    for name, rec in smoke.items():
        got = phases[f"lm_smoke_kernels:{name}"]["launches"]
        if got != {rec["kernel"]: rec["layers"]}:
            raise AssertionError(f"lm_smoke_kernels {name}: launches {got} "
                                 f"!= {rec['layers']} of {rec['kernel']}")
    for path, names in (("lm_score", configs), ("lm_serve", configs),
                        ("lm_smoke_kernels", smoke)):
        runs = [phases[f"{path}:{name}"] for name in names]
        total = {}
        for run in runs:
            for k, v in run["launches"].items():
                total[k] = total.get(k, 0) + v
        phases[path] = {"seconds": sum(r["seconds"] for r in runs),
                        "launches": total}

    # 11. every kernel against its plain version at its path's shapes
    rows = fabric_kernel_rows(fab.fabric(), device, batch=len(routed))
    rows.extend(fabric_kernel_rows(
        pred_fabric, device, batch=results["two_layer"]["lanes"],
        path="two_layer"))
    del pred_fabric
    rows.append(minplus_row(fab, device))
    rows.append(bbox_row(routed, device, earlier))
    rows.extend(sweep_rows(fab, routed, device, earlier))
    rows.append(hpwl_row(routed, device, earlier))
    rows.append(flash_row(device))
    rows.append(ssd_row(device, earlier["ssd_scan"]))
    rows.append(rv_kernel_row(rv_cases))
    del rv_cases
    # 12. the training path (after the LM models are freed)
    trained = phase("train", train_phase, device)
    if phases["train"]["launches"]:
        raise AssertionError(f"train launched kernels: "
                             f"{phases['train']['launches']}")
    # 12b. the dry run: the FULL cells on the fake production meshes, and
    # the card's own count of two programs against the fake's
    dried = phase("dryrun", dryrun_phase, device)
    # 13. the port's examples on the card
    examples = phase("examples", examples_phase, device)
    for row in rows:
        row.setdefault("path", KERNEL_PATH.get(row["name"], "main"))
        row["launches"] = phases[row["path"]]["launches"].get(row["name"],
                                                              0)
    for row in rows:
        row.setdefault("call_ms", row["ms"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
    keys = ("name", "route", "source", "replaces", "launches", "path",
            "max_abs_err", "ms", "plain_ms", "call_ms", "timing",
            "bound_ms", "bound_by", "bound_share", "library_ms", "shape")
    extra = ("tflops", "control_err", "plan", "shapes", "by_batch",
             "earlier_ms", "sweep_ms", "design")
    rows = [{**{k: row[k] for k in keys},
             **{k: row[k] for k in extra if k in row}} for row in rows]

    print(json.dumps({"phases": phases}))
    print(json.dumps({"pnr_seconds": report["pnr_s"],
                      "compile_seconds": report["compile_s"],
                      "nodes": report["nodes"],
                      "bitstream_words": report["bitstream_words"],
                      "placed_hpwl": report["placed_hpwl"],
                      "depths": report["depths"],
                      "pointwise_latency": report["pointwise_latency"]}))
    print(json.dumps({"emulation_ms": report["emulation_ms"],
                      "apps": len(routed), "cycles": T,
                      "io_chunk": IO_CHUNK,
                      "emulate_ms": results["emulate"]["emulate_ms"],
                      "emulate": results["emulate"]["per_app"]}))
    print(json.dumps({"verify": results["verify"]}))
    print(json.dumps({"serve": results["serve"]}, default=str))
    print(json.dumps({"engines": results["engines"]}))
    search = results["search"]
    print(json.dumps({"search": {"evaluated": search["evaluated"],
                                 "frontier": search["frontier"],
                                 "strategies": search["strategies"],
                                 "executor": search["stats"]["executor"]}},
                     default=str))
    print(json.dumps({"rv": results["rv"]}))
    print(json.dumps({"two_layer": results["two_layer"]}))
    print(json.dumps({"lm_score": score}))
    print(json.dumps({"lm_serve": served}))
    print(json.dumps({"lm_smoke_kernels": smoke}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"dryrun": dried}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"seconds": time.perf_counter() - t_start}))


if __name__ == "__main__":
    sys.exit(main())
