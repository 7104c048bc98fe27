"""Multi-pod dry run (counterpart of repro/launch/dryrun.py): trace every
(arch x shape x mesh) cell at full width and size it per device.

For each cell the step (a training step, or a prefill or decode step
against the cache) runs once on the production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: 16 x 16 or
2 x 16 x 16 ranks over a fake process group), wholly under a
``FakeTensorMode``: the parameters, optimizer state, cache and batch are
fake DTensors laid out by the reference's partition specs (pruned where
a dim does not divide, :func:`prune_specs`), so no byte of a FULL model
is allocated on the host or on the card. The step is rank 0's program:
every local op and collective it runs passes through the cost counter
(:class:`repro_torch.roofline.cost.CostCounter`), which gives the
per-device FLOPs, HBM bytes, link bytes and collectives, and tracks the
bytes of live local storage for ``memory_analysis``. Records land in
``experiments/dryrun_torch/<mesh>/<arch>/<shape>.json`` with the
reference record's keys, with two differences: there is no XLA
``cost_analysis_raw``, and the reference's ``hlo_parse_seconds`` is
``trace_seconds``, the time the traced step took (``compile_seconds`` is
the time to build the cell: the model, the state and its shardings).
``memory_analysis`` reads: ``argument_size_in_bytes`` the step's inputs
(state or parameters and cache, and the batch), ``output_size_in_bytes``
its outputs, ``alias_size_in_bytes`` the outputs that are inputs updated
in place (the cache), ``temp_size_in_bytes`` the live bytes over the
arguments at the step's peak. The roofline is the H100's.

``--device`` (default ``cuda``) is the device the fake tensors claim and
the mesh's device type. On a host whose PyTorch is built without CUDA
the fake tensors sit on the meta device instead, under the same cuda
mesh: indexing, copies and the autograd engine need a CUDA device guard,
which only a CUDA build has. The counts do not depend on it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
(--all runs the full matrix, one subprocess a cell.)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..configs import (SHAPES, canonical, cell_is_runnable, get_config,
                       input_specs, list_archs)
from ..models import build_model
from ..models.stacking import bind_params, stack_params
from ..optim import adafactor, adamw, cosine_schedule
from ..roofline.analysis import (active_params, count_params, model_flops,
                                 roofline_terms)
from ..roofline.cost import CostCounter
from ..roofline.hw import H100_SXM
from ..train.step import TrainState, make_train_step, train_state_specs
from .mesh import (P, batch_spec, distribute, make_production_mesh,
                   release_mesh, tree_shardings)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
CHIP = H100_SXM


def trace_device(device: str = "cuda") -> torch.device:
    """Where the fake tensors of a trace for ``device`` sit: ``device``,
    or the meta device for CUDA on a PyTorch built without it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        return torch.device("meta")
    return dev


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def prune_specs(spec_tree, abstract_tree, mesh):
    """Drop sharding on dims the shape can't divide (batch=1 decode cells,
    odd head counts), as the reference does for pjit."""
    axis_size = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def prune(spec, ab):
        if not hasattr(ab, "shape"):
            return spec
        shape = ab.shape
        new = []
        for i, axes in enumerate(spec):
            if axes is None or i >= len(shape):
                new.append(None if i >= len(shape) else axes)
                continue
            n = 1
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                n *= axis_size[a]
            new.append(axes if shape[i] % n == 0 else None)
        return P(*new)

    return _map(prune, spec_tree, abstract_tree)


def _map(fn, spec_tree, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of the same shape
    (mappings and named tuples)."""
    if isinstance(spec_tree, P):
        return fn(spec_tree, tree)
    if isinstance(spec_tree, dict):
        return {k: _map(fn, v, tree[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(_map(fn, s, t)
                                 for s, t in zip(spec_tree, tree)))
    return spec_tree


def shard_tree(tree, spec_tree, mesh):
    """``tree``'s tensors as DTensors of ``spec_tree`` on ``mesh`` (each
    rank keeping its own shard); other leaves as they are."""
    return _map(lambda s, t: (distribute(t, tree_shardings(mesh, s))
                              if isinstance(t, torch.Tensor) else t),
                spec_tree, tree)


def pick_optimizer(cfg):
    """Adafactor for the 1T cell (memory), AdamW elsewhere."""
    sched = cosine_schedule(3e-4, 100, 10_000)
    if cfg.moe is not None and cfg.moe.num_experts >= 256:
        return adafactor(sched)
    return adamw(sched)


def microbatches_for(cfg, shape) -> int:
    """Grad-accum so one microbatch of activations fits (the reference's
    heuristic, sized for its 16 GiB chips)."""
    if shape.kind != "train":
        return 0
    tokens = shape.global_batch * shape.seq_len
    if cfg.d_model >= 7168:
        mb = 8
    elif cfg.d_model >= 5120:
        mb = 4
    else:
        mb = 2 if tokens >= 2**20 else 0
    if cfg.moe is not None and cfg.moe.num_experts:
        mb = max(mb, 4)               # dispatch buffers scale with tokens
    return mb


class Cell(NamedTuple):
    """A built cell: ``run()`` runs its step once, on ``args`` (the
    step's inputs, whose local bytes are its arguments)."""
    run: Callable
    args: object
    no_grad: bool


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


def build_cell(arch: str, shape_name: str, mesh, *,
               attn_impl: Optional[str] = None,
               remat: Optional[str] = None,
               extra_tags: Optional[Dict] = None,
               cfg_overrides: Optional[Dict] = None,
               device: str = "cuda"):
    """(cell, meta) for one cell; call under :func:`fake_mode`."""
    cfg = get_config(arch)
    if attn_impl:
        cfg = cfg.replace(attn_impl=attn_impl)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    shape = SHAPES[shape_name]
    # full remat is the memory default for the 1M-token train cells
    cfg = cfg.replace(remat=remat or
                      ("full" if shape.kind == "train" else "none"))
    if "pod" in mesh.mesh_dim_names:
        cfg = cfg.replace(batch_axes=("pod", "data"))
    if not cell_is_runnable(cfg, shape):
        raise ValueError(f"{arch} x {shape_name} skipped "
                         f"(full attention at 512k)")
    dev = trace_device(device)
    model = build_model(cfg, dev)
    specs = input_specs(cfg, shape, dev)
    bspec = batch_spec(mesh)
    batch = shard_tree(specs, prune_specs({k: bspec for k in specs}, specs,
                                          mesh), mesh)
    params = stack_params(model)
    n_params = count_params(params)
    n_active = active_params(cfg, n_params)

    if shape.kind == "train":
        opt = pick_optimizer(cfg)
        step_fn = make_train_step(model, opt,
                                  microbatches=microbatches_for(cfg, shape))
        state = TrainState(params, opt.init(params),
                           torch.zeros((), dtype=torch.int32, device=dev))
        state = shard_tree(state, prune_specs(train_state_specs(model, opt),
                                              state, mesh), mesh)
        cell = Cell(lambda: step_fn(state, batch), (state, batch), False)
        tokens = shape.global_batch * shape.seq_len
        mflops = model_flops(n_active, tokens, "train")
    else:
        cache_len = shape.seq_len
        if cfg.vlm is not None:        # vision prefix occupies cache slots
            cache_len += cfg.vlm.num_patches
        cache = model.init_cache(shape.global_batch, cache_len)
        cache = shard_tree(cache, prune_specs(model.cache_specs(), cache,
                                              mesh), mesh)
        dparams = shard_tree(params, prune_specs(model.param_specs(),
                                                 params, mesh), mesh)
        bind_params(model, dparams)
        fwd = model.prefill if shape.kind == "prefill" else model.decode_step
        cell = Cell(lambda: fwd(cache, batch), (dparams, cache, batch), True)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind == "prefill" else 1)
        mflops = model_flops(n_active, tokens, "serve")

    meta = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "n_params": n_params, "n_params_active": n_active,
        "tokens": tokens, "model_flops": mflops,
        "mesh_axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_devices": int(mesh.size()),
        "device": device, "traced_on": str(dev),
    }
    if extra_tags:
        meta.update(extra_tags)
    return cell, meta


def count(run: Callable, args, no_grad: bool = False):
    """Run ``run()`` once under a :class:`CostCounter` whose live bytes
    start from ``args``' local storages; returns (counter, output,
    seconds, argument bytes)."""
    from torch.distributed.tensor.experimental import implicit_replication
    counter = CostCounter()
    grad = torch.no_grad() if no_grad else contextlib.nullcontext()
    with implicit_replication(), counter, grad:
        arg_bytes = counter.hold(_leaves(args))
        counter.reset_peak()
        t0 = time.perf_counter()
        out = run()
        seconds = time.perf_counter() - t0
    return counter, out, seconds, arg_bytes


def analyze(cell: Cell, meta: Dict, verbose: bool = True) -> Dict:
    counter, out, trace_s, arg_bytes = count(cell.run, cell.args,
                                             cell.no_grad)
    arg_st = {_local(t).untyped_storage()._cdata for t in _leaves(cell.args)}
    out_b, alias_b, seen = 0, 0, set()
    for t in _leaves(out):
        st = _local(t).untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        out_b += st.nbytes()
        alias_b += st.nbytes() if st._cdata in arg_st else 0
    mem = {"argument_size_in_bytes": int(arg_bytes),
           "output_size_in_bytes": int(out_b),
           "temp_size_in_bytes": int(counter.peak_bytes - arg_bytes),
           "alias_size_in_bytes": int(alias_b)}
    totals = counter.totals()
    n_dev = meta["n_devices"]
    flops_dev, bytes_dev = totals["flops"], totals["bytes"]
    link_bytes = totals["link_bytes"]
    terms = roofline_terms(flops_dev, bytes_dev, link_bytes, chip=CHIP)
    useful = meta["model_flops"] / max(flops_dev * n_dev, 1e-30)
    rec = {k: v for k, v in meta.items() if k != "build_seconds"}
    rec.update({
        "compile_seconds": meta.get("build_seconds", 0.0),
        "trace_seconds": trace_s,
        "memory_analysis": mem,
        "per_device_flops": flops_dev,
        "per_device_hbm_bytes": bytes_dev,
        "per_chip_link_bytes": link_bytes,
        "collectives": {
            "count": totals["n_collective_ops"],
            "by_kind_traffic": totals["collectives_by_kind"],
        },
        "roofline": terms,
        "useful_flops_ratio": useful,
        "chip": CHIP.name,
        "n_ops": counter.n_ops,
        "fits": counter.peak_bytes <= CHIP.hbm_bytes,
    })
    if verbose:
        print(f"  traced in {trace_s:.1f}s; "
              f"mem(args={arg_bytes / 1e9:.2f}GB "
              f"temp={mem['temp_size_in_bytes'] / 1e9:.2f}GB)/dev, "
              f"fits {CHIP.hbm_bytes / 1e9:.0f}GB: {rec['fits']}")
        print(f"  flops/dev={flops_dev:.3e} bytes/dev={bytes_dev:.3e} "
              f"link_bytes/chip={link_bytes:.3e} "
              f"collectives={totals['n_collective_ops']}")
        print(f"  roofline ({CHIP.name}): compute={terms['compute_s']:.4f}s "
              f"memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s "
              f"-> {terms['dominant']} bound, "
              f"fraction={terms['roofline_fraction']:.2f}, "
              f"useful_flops={useful:.2f}", flush=True)
    return rec


def train_program(cfg, batch: int, seq: int, microbatches: int = 0,
                  device="cuda", seed: Optional[int] = None, mesh=None):
    """(run, args) of one AdamW training step of ``cfg`` (rate 1e-4):
    its state and a (batch, seq) batch on ``device``. With a ``seed`` the
    weights and tokens are drawn from it; without one (under
    :func:`fake_mode`) they are left as made. On a ``mesh`` the state and
    the batch are DTensors of the reference's specs and ``run`` takes
    the sharded step."""
    model = build_model(cfg, device)
    if seed is not None:
        model.init_params(torch.Generator(device).manual_seed(seed))
    params = stack_params(model)
    bind_params(model, params)
    opt = adamw(1e-4)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=device))
    data = _ids(cfg, (batch, seq + 1), device, seed)
    data = {"tokens": data[:, :-1].contiguous(),
            "labels": data[:, 1:].contiguous()}
    step = make_train_step(model, opt, microbatches=microbatches)
    if mesh is None:
        return (lambda: step(state, data)), (state, data)
    from torch.distributed.tensor.experimental import implicit_replication
    state = shard_tree(state, prune_specs(train_state_specs(model, opt),
                                          state, mesh), mesh)
    data = shard_tree(data, prune_specs({k: batch_spec(mesh) for k in data},
                                        data, mesh), mesh)

    def run():
        with implicit_replication():
            return step(state, data)
    return run, (state, data)


def logits_program(cfg, batch: int, seq: int, device="cuda",
                   seed: Optional[int] = None):
    """(run, args) of ``cfg``'s whole-sequence forward (``logits``) on
    one rank, as :func:`train_program` makes its inputs."""
    model = build_model(cfg, device)
    if seed is not None:
        model.init_params(torch.Generator(device).manual_seed(seed))
    data = {"tokens": _ids(cfg, (batch, seq), device, seed)}
    return (lambda: model.logits(data)), (list(model.parameters()), data)


def _ids(cfg, shape, device, seed):
    if seed is None:
        return torch.empty(shape, dtype=torch.long, device=device)
    g = torch.Generator(device).manual_seed(seed + 1)
    return torch.randint(3, cfg.vocab_size - 1, shape, generator=g,
                         device=device)


def summary(counter: CostCounter, seconds: float, arg_bytes: int) -> Dict:
    """What a count of one program reads: its totals, the op count by op
    and the live-byte peak."""
    from collections import Counter
    return {**counter.totals(), "n_ops": counter.n_ops,
            "ops": dict(Counter(counter.op_names)),
            "argument_bytes": int(arg_bytes),
            "peak_bytes": int(counter.peak_bytes), "seconds": seconds}


def trace_one_rank(kind: str, cfg, batch: int, seq: int,
                   microbatches: int = 0, device: str = "cuda") -> Dict:
    """The dry run of one program at a one-rank mesh: ``kind`` "train"
    (:func:`train_program`) or "logits" (:func:`logits_program`) on fake
    tensors. A one-rank mesh shards nothing, so the program runs on
    plain fake tensors: the same ops as on the card."""
    dev = trace_device(device)
    with fake_mode():
        if kind == "train":
            run, args = train_program(cfg, batch, seq, microbatches, dev)
        else:
            run, args = logits_program(cfg, batch, seq, dev)
        counter, _, seconds, arg_bytes = count(run, args, kind != "train")
    return summary(counter, seconds, arg_bytes)


@contextlib.contextmanager
def production_mesh(mesh_kind: str, device: str = "cuda"):
    """The fake production mesh of ``mesh_kind`` ("single" or "multi"),
    its process group torn down on exit."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device_type=torch.device(device).type)
    try:
        yield mesh
    finally:
        release_mesh()


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             out_dir: str = OUT_DIR, device: str = "cuda",
             **build_kw) -> Dict:
    arch = canonical(arch)
    with production_mesh(mesh_kind, device) as mesh:
        print(f"[dryrun] {arch} x {shape_name} on {mesh_kind} "
              f"({mesh.size()} ranks)", flush=True)
        with fake_mode():
            t0 = time.perf_counter()
            cell, meta = build_cell(arch, shape_name, mesh, device=device,
                                    **build_kw)
            meta["build_seconds"] = time.perf_counter() - t0
            meta["mesh"] = mesh_kind
            rec = analyze(cell, meta)
    path = os.path.join(out_dir, mesh_kind, arch)
    os.makedirs(path, exist_ok=True)
    tag = rec.get("tag", "")
    fname = f"{shape_name}{('_' + tag) if tag else ''}.json"
    with open(os.path.join(path, fname), "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def iter_cells(mesh_kinds):
    for arch in list_archs():
        cfg = get_config(arch)
        for shape_name, shape in SHAPES.items():
            if not cell_is_runnable(cfg, shape):
                continue
            for mk in mesh_kinds:
                yield arch, shape_name, mk


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str, choices=list(SHAPES))
    ap.add_argument("--mesh", type=str, default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true",
                    help="run the full matrix, one subprocess a cell")
    ap.add_argument("--attn-impl", type=str, default=None)
    ap.add_argument("--remat", type=str, default=None)
    ap.add_argument("--tag", type=str, default=None,
                    help="suffix for the result file (perf experiments)")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides key=value (perf experiments), "
                         "e.g. --override attn_scores_f32=false")
    ap.add_argument("--out", type=str, default=OUT_DIR)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the device the fake tensors claim (the mesh's "
                         "device type)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.override:
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                pass
        overrides[k] = v

    mesh_kinds = (("single", "multi") if args.mesh == "both"
                  else (args.mesh,))

    if args.all:
        failures = []
        for arch, shape_name, mk in iter_cells(mesh_kinds):
            res_path = os.path.join(args.out, mk, arch,
                                    f"{shape_name}.json")
            if os.path.exists(res_path):
                print(f"[skip] {arch} x {shape_name} x {mk} (done)")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name, "--mesh", mk,
                   "--out", args.out, "--device", args.device]
            r = subprocess.run(cmd, cwd=os.getcwd())
            if r.returncode != 0:
                failures.append((arch, shape_name, mk))
        if failures:
            sys.exit(f"dry-run failures: {failures}")
        print("[dryrun] full matrix complete")
        return

    if not args.arch or not args.shape:
        ap.error("--arch and --shape are required without --all")
    extra = {"extra_tags": {"tag": args.tag}} if args.tag else {}
    run_cell(args.arch, args.shape, mesh_kinds[0], out_dir=args.out,
             device=args.device, attn_impl=args.attn_impl, remat=args.remat,
             cfg_overrides=overrides or None, **extra)


if __name__ == "__main__":
    main()
