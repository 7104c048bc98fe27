"""The port's cost counter (``repro_torch.roofline.cost``) and dry run
(``repro_torch.launch.dryrun``) against the JAX package's HLO cost model
and dry run.

Tolerances: FLOPs on one device equal the reference's ``HloCostModel``
within rel 1e-6 (both count 2 x output x contracted dims of every
matmul); the link-traffic model is the reference's, copied, so its
numbers are equal. Mamba2's gradient count is pinned apart: XLA counts
the transposes of the SSD's batch-only products (``bnc,bncp`` and the
``bnt`` scaling, forward multiplies in both) as two dots of 2 BH L P
FLOPs a layer, which autograd runs as a multiply and a sum. At one SSD
chunk XLA also folds away the inter-chunk product (its state is zero),
so Mamba2 runs at two chunks (S 64).
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.roofline import hlo_parse as ref_parse
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention, ops, ssd_scan
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, release_mesh
from repro_torch.models import build_model
from repro_torch.models.stacking import stack_params
from repro_torch.roofline import hlo_parse
from repro_torch.roofline.cost import CostCounter
from repro_torch.train.step import loss_fn, value_and_grad

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FAMILIES = ("tinyllama_1_1b", "granite_moe_3b_a800m", "internvl2_2b",
            "recurrentgemma_2b", "whisper_medium", "mamba2_1_3b")


# ------------------------------------------------------- the counter
def test_counter_matmul_chain_counts_exactly():
    a, b, c = torch.randn(7, 5), torch.randn(5, 3), torch.randn(2, 3, 4)
    with CostCounter() as cc:
        (a @ b) @ torch.randn(3, 6)
        torch.bmm(torch.randn(2, 7, 3), c)
    assert cc.flops == 2 * 7 * 5 * 3 + 2 * 7 * 3 * 6 + 2 * 2 * 7 * 3 * 4


def test_counter_sees_checkpoint_recompute():
    """``torch.utils.checkpoint`` reruns the forward in the backward pass:
    the counter sees the product three times (forward, recompute) plus
    its two gradient products."""
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)

    def f(x):
        return torch.tanh(x @ w)

    with CostCounter() as cc:
        torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False) \
            .sum().backward()
    with CostCounter() as plain:
        f(x).sum().backward()
    one = 2 * 4 * 8 * 8
    assert plain.flops == 2 * one          # forward + dL/dw (x needs none)
    assert cc.flops == 3 * one


def test_counter_bytes_by_hand():
    """Operands + output for a matmul and a gather, the output alone for
    an elementwise op and a reduction, nothing for a view."""
    a, b = torch.randn(16, 8), torch.randn(8, 4)
    idx = torch.zeros(5, dtype=torch.long)
    with CostCounter() as cc:
        y = a @ b                     # (16*8 + 8*4 + 16*4) * 4
        z = y.t()                     # a view: 0
        s = (z * 2).sum()             # 16*4*4 + 4
        g = a[idx]                    # (16*8 + 5*8) * 4 + 5*8 * 4
    del s, g
    want = ((16 * 8 + 8 * 4 + 16 * 4) * 4 + 16 * 4 * 4 + 4
            + (16 * 8 * 4 + 5 * 8 + 5 * 8 * 4))
    assert cc.bytes == want


def test_collective_model_is_the_references():
    """The copied parse and ring-factor model give the reference's
    records and traffic on its own test's HLO."""
    hlo = """
ENTRY %main {
  %ar = bf16[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}
  %ag = f32[2048]{0} all-gather(%y), replica_groups=[8,4]<=[32]
  %rs = (f32[64]{0}, bf16[32]{0}) reduce-scatter(%a, %b), \
replica_groups={{0,1}}
  %cp = s32[16]{0} collective-permute(%z), source_target_pairs={{0,1}}
}
"""
    mine, ref = hlo_parse.parse_collectives(hlo), \
        ref_parse.parse_collectives(hlo)
    assert mine == ref and len(mine) == 4
    assert hlo_parse.link_traffic_bytes(mine) == \
        ref_parse.link_traffic_bytes(ref)


def test_counter_records_collectives_with_their_group():
    """A functional all-reduce over a two-rank (fake) group is one record
    of its output bytes and group 2, the reference's all-reduce factor."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    mesh = make_host_mesh(model_axis=2, device_type="cpu", data_axis=1)
    try:
        with CostCounter() as cc:
            funcol.all_reduce(torch.ones(10, 4), "sum",
                              mesh.get_group("model")).wait()
    finally:
        release_mesh()
    assert not dist.is_initialized()
    assert cc.records == [{"kind": "all-reduce", "bytes": 160, "group": 2}]
    assert cc.totals()["link_bytes"] == 2 * 0.5 * 160


def test_kernel_ops_count_their_work():
    """The kernels run as custom ops with a FLOP formula: flash 4 D a
    causal (q, k) pair, the SSD scan the count of the chip smoke's bound;
    their fakes give the output's shape (the reference counts 0 FLOPs
    for a Pallas custom call: a kept difference)."""
    q, k = torch.randn(2, 4, 40, 16), torch.randn(2, 2, 40, 16)
    x, dt = torch.randn(3, 70, 8), torch.rand(3, 70)
    a, bc = -torch.rand(3), torch.randn(3, 70, 4)
    with CostCounter() as cc:
        ops.flash_attention(q, k, k)
        ops.ssd_scan(x, dt, a, bc, bc, chunk=32)
    assert cc.flops_by_op["canal.flash_attention"] == \
        4 * 2 * 4 * 16 * (40 * 41 // 2)
    lens = (32, 32, 6)
    assert cc.flops_by_op["canal.ssd_scan"] == 3 * (
        sum(c * (c + 1) * (4 + 8) for c in lens)
        + 2 * 4 * 8 * (sum(lens[1:]) + sum(lens[:-1])))
    assert flash_attention.causal_pairs(5, 3) == 6 + 2 * 3
    with dryrun.fake_mode():
        f = ops.flash_attention(*(torch.empty(1, 2, 9, 320)
                                  for _ in range(3)))
        y = ssd_scan.ssd_scan(torch.empty(2, 9, 4), torch.empty(2, 9),
                              torch.empty(2), torch.empty(2, 9, 3),
                              torch.empty(2, 9, 3))
    assert f.shape == (1, 2, 9, 320) and y.shape == (2, 9, 4)


# ----------------------------------------------------------- the dry run
REF_KEYS = {"arch", "shape", "kind", "n_params", "n_params_active",
            "tokens", "model_flops", "mesh_axes", "n_devices", "mesh",
            "compile_seconds", "memory_analysis", "per_device_flops",
            "per_device_hbm_bytes", "per_chip_link_bytes", "collectives",
            "roofline", "useful_flops_ratio"}


def test_decode_cell_on_a_fake_mesh_has_the_reference_record():
    """TinyLlama FULL's decode cell on a fake (2, 4) mesh of fake cuda
    tensors: the reference record's keys (its ``hlo_parse_seconds`` as
    ``trace_seconds``, no ``cost_analysis_raw``), every number positive,
    the collectives of a sharded step; and the kernel path of a sharded
    forward reaches the flash custom op's fake."""
    mesh = make_host_mesh(model_axis=4, data_axis=2, device_type="cuda")
    try:
        with dryrun.fake_mode():
            cell, meta = dryrun.build_cell("tinyllama-1.1b", "decode_32k",
                                           mesh)
            meta["mesh"] = "host"
            rec = dryrun.analyze(cell, meta, verbose=False)
            cfg = get_smoke("tinyllama_1_1b").replace(attn_impl="kernel")
            dev = dryrun.trace_device("cuda")
            model = build_model(cfg, dev)
            params = stack_params(model)
            sharded = dryrun.shard_tree(params, dryrun.prune_specs(
                model.param_specs(), params, mesh), mesh)
            from repro_torch.models.stacking import bind_params
            bind_params(model, sharded)
            tokens = dryrun.shard_tree(
                {"tokens": torch.empty((8, 32), dtype=torch.long,
                                       device=dev)},
                {"tokens": dryrun.batch_spec(mesh)}, mesh)
            counter, logits, _, _ = dryrun.count(
                lambda: model.logits(tokens), (sharded, tokens), True)
    finally:
        release_mesh()
    assert REF_KEYS | {"trace_seconds"} <= set(rec)
    assert "cost_analysis_raw" not in rec and "hlo_parse_seconds" not in rec
    assert set(rec["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert rec["n_devices"] == 8 and rec["mesh_axes"] == {"data": 2,
                                                          "model": 4}
    assert rec["chip"] == "h100-sxm"
    for k in ("per_device_flops", "per_device_hbm_bytes",
              "per_chip_link_bytes", "model_flops"):
        assert rec[k] > 0, k
    # the cache is updated in place: its bytes alias the arguments'
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0
    assert rec["collectives"]["count"] > 0
    assert 0 < rec["useful_flops_ratio"] <= 1.05
    assert counter.op_names.count("canal.flash_attention") == \
        cfg.num_layers
    assert logits.shape == (8, 32, cfg.padded_vocab)


def test_dryrun_cli_runs_a_cell_without_a_gpu(tmp_path):
    """``python -m repro_torch.launch.dryrun`` (``--device cuda`` by
    default) traces a FULL cell (Mamba2's 500k-token decode) on the
    256-rank production mesh on this host and writes its record."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "mamba2-1.3b", "--shape", "long_500k",
                        "--out", str(tmp_path)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.load(open(tmp_path / "single" / "mamba2_1_3b" /
                         "long_500k.json"))
    assert rec["n_devices"] == 256 and rec["device"] == "cuda"
    assert REF_KEYS <= set(rec) and rec["per_device_flops"] > 0


# ------------------------------------------- one device vs HloCostModel
def _batch(cfg, b, s, lib):
    out = {"tokens": lib.zeros((b, s)), "labels": lib.zeros((b, s))}
    if cfg.vlm is not None:
        out["patches"] = lib.zeros((b, cfg.vlm.num_patches,
                                    cfg.vlm.d_patch))
    if cfg.encdec is not None:
        out["frames"] = lib.zeros((b, cfg.encdec.encoder_seq,
                                   cfg.encdec.d_frame))
    return out


#: the reference's counts, one process a (family, remat): its HLO cost
#: model takes up to half a minute on a Whisper gradient program, so the
#: twelve run side by side while the tests above run
_REF_SCRIPT = """
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_smoke
from repro.models import build_model
from repro.roofline.hlo_cost import HloCostModel
from repro.train import step
arch, remat, s = sys.argv[1], sys.argv[2], int(sys.argv[3])
cfg = get_smoke(arch).replace(param_dtype="float32",
                              activation_dtype="float32", remat=remat,
                              ce_seq_chunk=16)
m = build_model(cfg)
params = jax.eval_shape(m.init_params, jax.random.PRNGKey(0))
batch = {"tokens": jax.ShapeDtypeStruct((4, s), jnp.int32),
         "labels": jax.ShapeDtypeStruct((4, s), jnp.int32)}
if cfg.vlm is not None:
    batch["patches"] = jax.ShapeDtypeStruct(
        (4, cfg.vlm.num_patches, cfg.vlm.d_patch), jnp.float32)
if cfg.encdec is not None:
    batch["frames"] = jax.ShapeDtypeStruct(
        (4, cfg.encdec.encoder_seq, cfg.encdec.d_frame), jnp.float32)
loss = lambda p, b: step.loss_fn(m, p, b)[0]
print(json.dumps([HloCostModel(jax.jit(f).lower(params, batch).compile()
                               .as_text()).totals()["flops"]
                  for f in (loss, jax.value_and_grad(loss))]))
"""


def _seq(arch):
    return 64 if arch == "mamba2_1_3b" else 32


@pytest.fixture(scope="module", autouse=True)
def ref_counts():
    """Starts the reference's twelve counts at the module's first test;
    a test waits for its own."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    procs = {(a, r): subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, a, r, str(_seq(a))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a in FAMILIES for r in ("none", "full")}
    done = {}

    def get(arch, remat):
        if (arch, remat) not in done:
            out, err = procs[arch, remat].communicate(timeout=600)
            assert procs[arch, remat].returncode == 0, err[-3000:]
            done[arch, remat] = json.loads(out.strip().splitlines()[-1])
        return done[arch, remat]

    yield get
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _port_flops(arch, remat, s):
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32", remat=remat,
                                  ce_seq_chunk=16)
    with dryrun.fake_mode():
        model = build_model(cfg, "cpu")
        params = stack_params(model)
        batch = {k: v.long() if k in ("tokens", "labels") else v
                 for k, v in _batch(cfg, 4, s, torch).items()}
        model.requires_grad_(True)
        with CostCounter() as fwd, torch.no_grad():
            loss_fn(model, params, batch)
        with CostCounter() as both:
            value_and_grad(model, params, batch)
    return fwd.flops, both.flops, cfg


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_one_device_flops_equal_hlo_cost_model(ref_counts, arch, remat):
    """The smoke ``loss_fn`` and ``value_and_grad`` (f32, B 4 x S 32,
    two cross-entropy chunks) count the reference's FLOPs, the recompute
    of remat ``full`` included (Mamba2 at S 64 with its pinned gap)."""
    s = _seq(arch)
    got_fwd, got_vg, cfg = _port_flops(arch, remat, s)
    if arch == "mamba2_1_3b":
        # per layer the two batch-only SSD products' transposes, each
        # 2 BH L P FLOPs in XLA's count (BH = batch x heads)
        d_in = cfg.ssm.expand * cfg.d_model
        bh, p = 4 * (d_in // cfg.ssm.head_dim), cfg.ssm.head_dim
        got_vg += cfg.num_layers * 2 * (2 * bh * s * p)
    want_fwd, want_vg = ref_counts(arch, remat)
    assert got_fwd == pytest.approx(want_fwd, rel=1e-6)
    assert got_vg == pytest.approx(want_vg, rel=1e-6)
