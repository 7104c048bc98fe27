"""The port's sharded LM (``repro_torch.launch.mesh``, the ``*_specs``
helpers, the in-model constraints) against the JAX package.

* The partition-spec trees of all ten FULL configs (parameters, cache,
  AdamW and Adafactor state, the training state) equal the reference's
  as tuples, keys and their order included; ``prune_specs`` equals the
  reference's on the FULL shapes at both production meshes (the
  reference in a subprocess, which sets its own 512 host devices).
* Per-device FLOPs of the smoke training step (B 8 x S 32, f32, AdamW)
  on a fake (2, 4) mesh are within 10% of the reference's on an
  8-host-device (2, 4) mesh, for the dense, MoE and SSM families (a step
  that replicates its activations counts about 4x); link bytes within
  2x of it.
* On a real two-rank ``gloo`` group, at (data 2, model 1) and (data 1,
  model 2), the sharded step's loss and every gradient are within 1e-5
  (absolute, float32) of the unsharded port's; so are sharded serving
  (a cache split on the batch, the sequence or the heads), expert
  parallelism and a whole Adafactor step.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.train.step import train_state_specs as ref_train_state_specs
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (P, make_host_mesh,
                                     make_production_mesh, release_mesh)
from repro_torch.models import build_model
from repro_torch.models.stacking import stack_params
from repro_torch.optim import adafactor, adamw
from repro_torch.train.step import train_state_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC + os.pathsep
           + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
SHARDED = ("tinyllama_1_1b", "granite_moe_3b_a800m", "mamba2_1_3b")


def norm(tree):
    """A spec tree as nested lists: (key, subtree) pairs in order, a
    named tuple's fields in order, a spec as a plain tuple."""
    if isinstance(tree, dict):
        return [(k, norm(v)) for k, v in tree.items()]
    if hasattr(tree, "_fields"):
        return [(f, norm(v)) for f, v in zip(tree._fields, tree)]
    return tuple(tuple(e) if isinstance(e, list) else e for e in tree)


# ------------------------------------------------------ the spec trees
@pytest.mark.parametrize("arch", list_archs())
def test_spec_trees_equal_the_references(arch):
    """``param_specs``, ``cache_specs``, the optimizers' ``state_specs``
    and ``train_state_specs`` of the FULL config, against the
    reference's."""
    jm = ref_build_model(ref_get_config(arch))
    model = build_model(get_config(arch), "meta")
    assert norm(model.param_specs()) == norm(jm.param_specs())
    assert norm(model.cache_specs()) == norm(jm.cache_specs())
    for mine, ref in ((adamw(1e-3), ref_adamw(1e-3)),
                      (adafactor(1e-3), ref_adafactor(1e-3))):
        assert norm(mine.state_specs(model.param_specs())) == \
            norm(ref.state_specs(jm.param_specs()))
        assert norm(train_state_specs(model, mine)) == \
            norm(ref_train_state_specs(jm, ref))
    assert all(isinstance(s, P) for s in model.param_specs().values()
               if not isinstance(s, dict))


_PRUNE_SCRIPT = """
import json
import jax
from repro.configs import get_config, list_archs
from repro.launch.dryrun import prune_specs
from repro.launch.mesh import make_production_mesh
from repro.models import build_model
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in list_archs():
        m = build_model(get_config(arch))
        ab = jax.eval_shape(m.init_params, jax.random.PRNGKey(0))
        specs = prune_specs(m.param_specs(), ab, mesh)
        out[f"{multi}/{arch}"] = jax.tree.map(
            lambda s: list(s), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_pruned():
    r = subprocess.run([sys.executable, "-c", _PRUNE_SCRIPT], env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _plain(tree):
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in tree]


@pytest.mark.parametrize("multi", [False, True])
def test_prune_specs_equal_the_references(ref_pruned, multi):
    """Every FULL config's parameter specs pruned to its shapes on the
    256- and 512-rank production meshes (odd head counts, expert counts
    that do not divide), against the reference's."""
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    try:
        for arch in list_archs():
            model = build_model(get_config(arch), "meta")
            got = dryrun.prune_specs(model.param_specs(),
                                     stack_params(model), mesh)
            assert _plain(got) == ref_pruned[f"{multi}/{arch}"], arch
    finally:
        release_mesh()


# --------------------------------------------- sharded per-device counts
_REF_SHARDED = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.models import build_model
from repro.optim import adamw
from repro.roofline.hlo_cost import HloCostModel
from repro.train.step import init_train_state, make_train_step, \\
    train_state_specs
out = {}
mesh = jax.make_mesh((2, 4), ("data", "model"))
sizes = dict(zip(mesh.axis_names, mesh.devices.shape))


def prune(spec, ab):
    new = []
    for i, axes in enumerate(spec):
        if axes is None or i >= len(ab.shape):
            new.append(None if i >= len(ab.shape) else axes)
            continue
        n = 1
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= sizes[a]
        new.append(axes if ab.shape[i] % n == 0 else None)
    return P(*new)


for arch in sys.argv[1:]:
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32",
                                  ce_seq_chunk=16)
    model, opt = build_model(cfg), adamw(1e-3)
    state = jax.eval_shape(lambda r: init_train_state(model, opt, r),
                           jax.random.PRNGKey(0))
    specs = jax.tree.map(prune, train_state_specs(model, opt), state,
                         is_leaf=lambda x: isinstance(x, P))
    ssh = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                       is_leaf=lambda x: isinstance(x, P))
    bsh = {k: NamedSharding(mesh, P("data")) for k in ("tokens", "labels")}
    batch = {k: jax.ShapeDtypeStruct((8, 32), jnp.int32)
             for k in ("tokens", "labels")}
    step = jax.jit(make_train_step(model, opt), in_shardings=(ssh, bsh))
    with mesh:
        t = HloCostModel(step.lower(state, batch).compile().as_text()) \\
            .totals()
    out[arch] = {"flops": t["flops"], "link_bytes": t["link_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def ref_sharded():
    """The reference's partitioned counts, started at the module's first
    test (it compiles for most of a minute) and read by the last."""
    proc = subprocess.Popen([sys.executable, "-c", _REF_SHARDED, *SHARDED],
                            env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def port_sharded(arch):
    """Per-device FLOPs and link bytes of the port's smoke step on a fake
    (2, 4) mesh of fake tensors."""
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32",
                                  ce_seq_chunk=16)
    mesh = make_host_mesh(model_axis=4, data_axis=2, device_type="cuda")
    try:
        with dryrun.fake_mode():
            run, args = dryrun.train_program(
                cfg, 8, 32, 0, dryrun.trace_device("cuda"), mesh=mesh)
            counter, _, _, _ = dryrun.count(run, args)
    finally:
        release_mesh()
    return counter.totals()


# --------------------------------------------- numerics on two real ranks
_GLOO_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.stacking import stack_params
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_items

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
res = {}
for arch in ("tinyllama_1_1b", "granite_moe_3b_a800m", "recurrentgemma_2b",
             "mamba2_1_3b"):
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32",
                                  ce_seq_chunk=16)
    for data, model_axis in ((2, 1), (1, 2)):
        model = build_model(cfg, "cpu")
        model.init_params(torch.Generator().manual_seed(0))
        params = stack_params(model)
        g = torch.Generator().manual_seed(1)
        t = torch.randint(3, cfg.vocab_size - 1, (8, 33), generator=g)
        batch = {"tokens": t[:, :-1].contiguous(),
                 "labels": t[:, 1:].contiguous()}
        model.requires_grad_(True)
        loss, _, grads = value_and_grad(model, params, batch)
        mesh = make_host_mesh(model_axis, "cpu", data_axis=data)
        sp = dryrun.shard_tree(params, dryrun.prune_specs(
            model.param_specs(), params, mesh), mesh)
        sb = dryrun.shard_tree(batch, dryrun.prune_specs(
            {k: dryrun.batch_spec(mesh) for k in batch}, batch, mesh), mesh)
        with implicit_replication():
            sloss, _, sgrads = value_and_grad(model, sp, sb)
        errs = {"loss": abs(float(sloss.full_tensor()) - float(loss))}
        want = dict(tree_items(grads))
        for k, v in tree_items(sgrads):
            errs[k] = float((v.full_tensor() - want[k]).abs().max())
        res[f"{arch}/{data}x{model_axis}"] = errs
if rank == 0:
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def gloo_runs(tmp_path_factory):
    """Both two-rank runs, started at the module's first test (each rank
    single-threaded); a test waits for its own."""
    out = tmp_path_factory.mktemp("gloo")
    runs = {}
    for name, script in (("grads", _GLOO_WORKER), ("serve", _SERVE_WORKER)):
        port, path = _free_port(), out / f"{name}.json"
        runs[name] = (path, [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(port), str(path)],
            env=ENV, stderr=subprocess.PIPE, text=True) for r in (0, 1)])

    def result(name):
        path, procs = runs[name]
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
        return json.load(open(path))

    yield result
    for _, procs in runs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def test_sharded_step_numerics_on_two_gloo_ranks(gloo_runs):
    """TinyLlama, Granite-MoE, RecurrentGemma and Mamba2 smoke: loss and
    every gradient of the step sharded over two real ranks (data, then
    model) within 1e-5 of the unsharded port's."""
    errs = gloo_runs("grads")
    assert len(errs) == 8
    for case, by_leaf in errs.items():
        worst = max(by_leaf, key=by_leaf.get)
        assert by_leaf[worst] <= 1e-5, (case, worst, by_leaf[worst])


def test_sharded_step_splits_the_work_as_the_reference(ref_sharded):
    """Per-device FLOPs within 10% of the reference's partitioned HLO,
    link bytes within 2x; both printed."""
    mine = {arch: port_sharded(arch) for arch in SHARDED}
    out, err = ref_sharded.communicate(timeout=600)
    assert ref_sharded.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    for arch in SHARDED:
        got, want = mine[arch], ref[arch]
        print(f"{arch}: FLOPs/device port {got['flops']:.4e} reference "
              f"{want['flops']:.4e}; link bytes port "
              f"{got['link_bytes']:.4e} reference {want['link_bytes']:.4e}")
        assert got["flops"] == pytest.approx(want["flops"], rel=0.10), arch
        assert want["link_bytes"] / 2 <= got["link_bytes"] \
            <= 2 * want["link_bytes"], arch


_SERVE_WORKER = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.models.config import MoEConfig
from repro_torch.models.stacking import bind_params, stack_params
from repro_torch.train.step import value_and_grad
from repro_torch.tree import tree_items

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
res = {}
g = torch.Generator().manual_seed(1)
for arch, data, model_axis in (("tinyllama_1_1b", 2, 1),
                               ("tinyllama_1_1b", 1, 2),
                               ("recurrentgemma_2b", 1, 2),
                               ("whisper_medium", 2, 1),
                               ("whisper_medium", 1, 2),
                               ("mamba2_1_3b", 1, 2)):
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32")
    first = {"tokens": torch.randint(3, cfg.vocab_size - 1, (4, 8),
                                     generator=g)}
    if cfg.encdec is not None:
        first["frames"] = 0.1 * torch.randn(
            (4, cfg.encdec.encoder_seq, cfg.encdec.d_frame), generator=g)
    nxt = torch.randint(3, cfg.vocab_size - 1, (4, 2), generator=g)
    model = build_model(cfg, "cpu")
    model.init_params(torch.Generator().manual_seed(0))
    params = stack_params(model)
    want = []
    cache = model.init_cache(4, 16)
    with torch.no_grad():
        lg, cache = model.prefill(cache, first)
        want.append(lg)
        for i in range(2):
            lg, cache = model.decode_step(cache, {"tokens": nxt[:, i:i + 1]})
            want.append(lg)
    mesh = make_host_mesh(model_axis, "cpu", data_axis=data)
    sp = dryrun.shard_tree(params, dryrun.prune_specs(
        model.param_specs(), params, mesh), mesh)
    bind_params(model, sp)
    cache = model.init_cache(4, 16)
    cache = dryrun.shard_tree(cache, dryrun.prune_specs(
        model.cache_specs(), cache, mesh), mesh)

    def batch(t):
        t = t if isinstance(t, dict) else {"tokens": t}
        return dryrun.shard_tree(t, dryrun.prune_specs(
            {k: dryrun.batch_spec(mesh) for k in t}, t, mesh), mesh)

    got = []
    with torch.no_grad(), implicit_replication():
        lg, cache = model.prefill(cache, batch(first))
        got.append(lg)
        for i in range(2):
            lg, cache = model.decode_step(cache, batch(nxt[:, i:i + 1]))
            got.append(lg)
    res[f"serve/{arch}/{data}x{model_axis}"] = max(
        float((a.full_tensor() - b).abs().max() / b.abs().max().clamp_min(1))
        for a, b in zip(got, want))
# expert parallel: 16 experts, a whole expert a rank on model
cfg = get_smoke("tinyllama_1_1b").replace(param_dtype="float32",
                                          activation_dtype="float32")
kcfg = get_smoke("kimi_k2_1t_a32b")
kcfg = kcfg.replace(param_dtype="float32", activation_dtype="float32",
                    ce_seq_chunk=16, moe=MoEConfig(
                        num_experts=16, top_k=2, d_ff_expert=32,
                        capacity_factor=1.25, first_k_dense=1,
                        d_ff_shared=32))
model = build_model(kcfg, "cpu")
model.init_params(torch.Generator().manual_seed(0))
params = stack_params(model)
t = torch.randint(3, kcfg.vocab_size - 1, (8, 33), generator=g)
b = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
model.requires_grad_(True)
loss, _, grads = value_and_grad(model, params, b)
mesh = make_host_mesh(2, "cpu", data_axis=1)
sp = dryrun.shard_tree(params, dryrun.prune_specs(
    model.param_specs(), params, mesh), mesh)
sb = dryrun.shard_tree(b, dryrun.prune_specs(
    {k: dryrun.batch_spec(mesh) for k in b}, b, mesh), mesh)
with implicit_replication():
    sloss, _, sgrads = value_and_grad(model, sp, sb)
want = dict(tree_items(grads))
errs = {"loss": abs(float(sloss.full_tensor()) - float(loss))}
for k, v in tree_items(sgrads):
    errs[k] = float((v.full_tensor() - want[k]).abs().max())
res["experts/1x2"] = max(errs.values())
# a whole Adafactor step (factored second moments of sharded leaves)
from repro_torch.optim import adafactor
from repro_torch.train.step import TrainState, make_train_step, \
    train_state_specs
model = build_model(cfg.replace(ce_seq_chunk=16), "cpu")
model.init_params(torch.Generator().manual_seed(0))
opt = adafactor(1e-2)
t = torch.randint(3, cfg.vocab_size - 1, (8, 33), generator=g)
b = {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def fresh():
    params = stack_params(model)
    return TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))


step = make_train_step(model, opt)
first, state = fresh(), fresh()       # the step rebinds the model
want, _ = step(first, b)
mesh = make_host_mesh(2, "cpu", data_axis=1)
state = dryrun.shard_tree(state, dryrun.prune_specs(
    train_state_specs(model, opt), state, mesh), mesh)
sb = dryrun.shard_tree(b, dryrun.prune_specs(
    {k: dryrun.batch_spec(mesh) for k in b}, b, mesh), mesh)
with implicit_replication():
    got, _ = step(state, sb)
w = dict(tree_items(want.params))
res["adafactor/1x2"] = max(float((v.full_tensor() - w[k]).abs().max())
                           for k, v in tree_items(got.params))
if rank == 0:
    json.dump(res, open(out, "w"))
dist.destroy_process_group()
"""


def test_sharded_serving_and_expert_parallel_on_two_gloo_ranks(gloo_runs):
    """On two real ``gloo`` ranks: TinyLlama smoke's prefill and two
    decode steps against a cache sharded on the batch (data 2) or on the
    sequence (model 2; the ranks' partial softmax sums merged), the same
    for RecurrentGemma smoke's rolling window (model 2), Whisper smoke's
    self and cross caches (heads on model 2, or data 2) and Mamba2
    smoke's states (model 2), a Kimi
    K2 smoke step with 16 experts, a whole expert a rank (expert
    parallel), and a whole Adafactor step of TinyLlama over model 2,
    within 1e-5 of the unsharded port's (float32): the logits relative to
    the largest (at least 1), the loss, gradients and updated parameters
    absolute."""
    errs = gloo_runs("serve")
    assert set(errs) == {"serve/tinyllama_1_1b/2x1",
                         "serve/tinyllama_1_1b/1x2",
                         "serve/recurrentgemma_2b/1x2",
                         "serve/whisper_medium/2x1",
                         "serve/whisper_medium/1x2",
                         "serve/mamba2_1_3b/1x2", "experts/1x2",
                         "adafactor/1x2"}
    for case, err in errs.items():
        assert err <= 1e-5, (case, err)
