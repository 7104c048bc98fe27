"""The training path of the port (``repro_torch.train``, ``optim``,
``data``, ``ckpt``, ``runtime``, ``launch.train``) against the JAX
package, at the smoke configs, with the reference's state carried over
by ``interop.train_state_from_numpy``.

Tolerances: in float32 the two packages differ only in summation order,
so loss, accuracy, every gradient and three optimizer steps agree within
rtol 1e-4 (an element near zero is held to 1e-4 of its leaf's largest
magnitude). A bf16 leaf (a bf16 parameter, Adafactor's bf16 first
moment, in float32 training too) may round one bf16 ulp apart (rtol
2^-7), and a float32 leaf computed from it moves by that ulp times the
rate. The data, the int8 codec, error
feedback, the straggler monitor and the checkpoint files are
bit-identical.
"""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import get_smoke as ref_get_smoke
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import build_model as ref_build_model
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import linear_warmup as ref_warmup
from repro.runtime import StragglerMonitor as RefStragglerMonitor
from repro.runtime import compression as ref_comp
from repro.train import step as ref_step
from repro_torch import interop
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.stacking import bind_params
from repro_torch.optim import (adafactor, adamw, cosine_schedule,
                               linear_warmup)
from repro_torch.runtime import StragglerMonitor, Supervisor
from repro_torch.runtime import compression as comp
from repro_torch.train.step import (TrainState, init_train_state, loss_fn,
                                    make_train_step, value_and_grad)
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                               tree_unflatten)

ARCHS = ("tinyllama_1_1b", "mamba2_1_3b")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@functools.lru_cache(maxsize=None)
def ref_model(arch, dtype="float32", remat="none", impl="xla"):
    jcfg = ref_get_smoke(arch).replace(param_dtype=dtype,
                                       activation_dtype=dtype,
                                       ce_seq_chunk=16, remat=remat,
                                       attn_impl=impl)
    return jcfg, ref_build_model(jcfg)


def port_model(jcfg):
    cfg = interop.lm_config_from_fields(dataclasses.asdict(jcfg))
    return build_model(cfg, "cpu")


def to_port(cfg, jstate):
    return interop.train_state_from_numpy(
        cfg, jax.tree.map(np.asarray, jstate._asdict()), "cpu")


def batches(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(3, cfg.vocab_size - 1, (b, s + 1)).astype(np.int32)
    j = {"tokens": jnp.asarray(t[:, :-1]), "labels": jnp.asarray(t[:, 1:])}
    p = {"tokens": torch.as_tensor(t[:, :-1]).long(),
         "labels": torch.as_tensor(t[:, 1:]).long()}
    return j, p


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, rtol=1e-4):
    """Within ``rtol`` of ``want``, or of its largest magnitude; a bf16
    leaf within one bf16 ulp (rtol 2^-7)."""
    bf16 = isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    want = np32(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(np32(got), want,
                               rtol=max(rtol, 2.0 ** -7) if bf16 else rtol,
                               atol=rtol * scale)


def close_trees(got, want, rtol=1e-4):
    """``got`` (port tree) against ``want`` (reference pytree), leaf for
    leaf in the reference's order, keys included."""
    g = list(tree_items(got))
    w = [k for k, _ in tree_items(jax.tree.map(lambda _: 0, want))]
    assert [k for k, _ in g] == w
    for (key, a), b in zip(g, jax.tree.leaves(want)):
        close(a, b, rtol)


# ------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Loss, accuracy and every gradient against ``jax.value_and_grad``
    in float32 (the gradient tree in the reference's stacked layout)."""
    jcfg, jm = ref_model(arch)
    jstate = ref_step.init_train_state(jm, ref_adamw(1e-3),
                                       jax.random.PRNGKey(0))
    jb, pb = batches(jcfg)
    (jl, jmx), jg = jax.value_and_grad(
        lambda p: ref_step.loss_fn(jm, p, jb), has_aux=True)(jstate.params)
    model = port_model(jcfg).requires_grad_(True)
    state = to_port(model.cfg, jstate)
    loss, mx, g = value_and_grad(model, state.params, pb)
    close(loss, jl)
    close(mx["accuracy"], jmx["accuracy"])
    close_trees(g, jg)


def test_chunked_ce_matches_naive_and_reference():
    """The chunked CE (chunks of 16 over S 32, pad vocab masked) equals a
    naive log-softmax over the whole logits, and the reference's."""
    jcfg, jm = ref_model("tinyllama_1_1b")
    jstate = ref_step.init_train_state(jm, ref_adamw(1e-3),
                                       jax.random.PRNGKey(1))
    jb, pb = batches(jcfg, seed=1)
    model = port_model(jcfg)
    state = to_port(model.cfg, jstate)
    with torch.no_grad():
        loss, mx = loss_fn(model, state.params, pb)
        logits = model.logits(pb)
    cfg = model.cfg
    masked = torch.where(torch.arange(cfg.padded_vocab) < cfg.vocab_size,
                         logits, torch.full_like(logits, -1e30))
    naive = -torch.gather(torch.log_softmax(masked, -1), -1,
                          pb["labels"][..., None]).mean()
    np.testing.assert_allclose(float(loss), float(naive), rtol=1e-5)
    jl, jmx = ref_step.loss_fn(jm, jstate.params, jb)
    close(loss, jl)
    close(mx["accuracy"], jmx["accuracy"])


def test_kernel_branch_refuses_to_train():
    """The kernels have no backward. The reference's Pallas branch fails
    under ``jax.grad`` (its pallas_call JVP rule asserts); the port
    refuses ``attn_impl="kernel"`` before the first step."""
    jcfg, jm = ref_model("tinyllama_1_1b", impl="pallas")
    params = jm.init_params(jax.random.PRNGKey(0))
    jb, pb = batches(jcfg, b=2, s=16)
    with pytest.raises(AssertionError):
        jax.grad(lambda p: ref_step.loss_fn(jm, p, jb)[0])(params)
    model = port_model(jcfg)
    assert model.cfg.attn_impl == "kernel"
    with pytest.raises(ValueError, match="no backward"):
        make_train_step(model, adamw(1e-3))


# ----------------------------------------------------------- optimizers
def test_schedules_match_reference():
    for ref, mine in ((ref_warmup(3e-3, 7), linear_warmup(3e-3, 7)),
                      (ref_cosine(3e-3, 5, 20), cosine_schedule(3e-3, 5,
                                                                20)),
                      (ref_cosine(1.0, 0, 3, 0.2), cosine_schedule(1.0, 0, 3,
                                                                   0.2))):
        for s in range(25):
            want = np.float32(ref(jnp.int32(s)))
            got = mine(s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, rtol=1e-6)
            assert float(mine(torch.tensor(s, dtype=torch.int32))) == \
                float(got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name, dtype):
    """Three updates on the same parameters and gradients, the rate from
    a cosine schedule: parameters and every optimizer leaf agree
    (Adafactor factors each stacked matrix, norm scales included)."""
    make = {"adamw": (ref_adamw, adamw),
            "adafactor": (ref_adafactor, adafactor)}[name]
    jopt = make[0](ref_cosine(1e-2, 2, 3), weight_decay=0.1)
    opt = make[1](cosine_schedule(1e-2, 2, 3), weight_decay=0.1)
    jcfg, jm = ref_model("tinyllama_1_1b", dtype)
    jp = jm.init_params(jax.random.PRNGKey(2))
    tp = tree_map(lambda a: interop._leaf_tensor(a, None, "cpu"),
                  jax.tree.map(np.asarray, jp))
    jos, tos = jopt.init(jp), opt.init(tp)
    close_trees(tos, jos)
    rng = np.random.default_rng(3)
    for step in range(3):
        draws = [rng.standard_normal(np.shape(x)).astype(np.float32)
                 for x in jax.tree.leaves(jp)]
        jg = jax.tree.unflatten(jax.tree.structure(jp), [
            jnp.asarray(d).astype(x.dtype)
            for d, x in zip(draws, jax.tree.leaves(jp))])
        tg = tree_unflatten(tp, [torch.from_numpy(d).to(p.dtype)
                                 for d, p in zip(draws, tree_leaves(tp))])
        ju, jos = jopt.update(jg, jos, jp, jnp.int32(step))
        jp = jax.tree.map(lambda p, u: p + u, jp, ju)
        tu, tos = opt.update(tg, tos, tp, torch.tensor(step,
                                                       dtype=torch.int32))
        tp = tree_map(lambda p, u: p + u, tp, tu)
    rtol = 1e-4 if dtype == "float32" else 2.0 ** -7
    close_trees(tp, jp, rtol)
    close_trees(tos, jos, rtol)


# ------------------------------------------------------ the train step
def test_microbatches_match_full_batch_and_reference():
    """``microbatches=2`` accumulates f32 gradients and means them: equal
    to the full batch's step within float32 rounding, and to the
    reference's two-microbatch step."""
    jcfg, jm = ref_model("tinyllama_1_1b")
    jopt, opt = ref_adamw(1e-3), adamw(1e-3)
    jstate = ref_step.init_train_state(jm, jopt, jax.random.PRNGKey(0))
    jb, pb = batches(jcfg)
    jnew, jmx = jax.jit(ref_step.make_train_step(jm, jopt,
                                                 microbatches=2))(jstate, jb)
    model = port_model(jcfg)
    full, fmx = make_train_step(model, opt)(to_port(model.cfg, jstate), pb)
    two, tmx = make_train_step(model, opt, microbatches=2)(
        to_port(model.cfg, jstate), pb)
    for a, b in zip(tree_leaves(two.params), tree_leaves(full.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    close(tmx["loss"], fmx["loss"])
    close_trees(two.params, jnew.params)
    close_trees(two.opt, jnew.opt)
    close(tmx["loss"], jmx["loss"])
    assert int(two.step) == int(jnew.step) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_equal(arch):
    """``none``, ``full`` and ``dots`` recompute the same values: the
    gradients are equal bit for bit."""
    grads = {}
    for remat in ("none", "full", "dots", "dots_no_batch"):
        jcfg, _ = ref_model(arch)
        model = port_model(jcfg.replace(remat=remat)).requires_grad_(True)
        state = init_train_state(model, adamw(1e-3),
                                 torch.Generator().manual_seed(0))
        _, pb = batches(jcfg)
        grads[remat] = value_and_grad(model, state.params, pb)[2]
    for remat in ("full", "dots", "dots_no_batch"):
        for a, b in zip(tree_leaves(grads[remat]),
                        tree_leaves(grads["none"])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_recomputes_what_the_policy_drops():
    """In the backward pass ``full`` recomputes each layer's matmuls,
    ``dots`` keeps them and recomputes the rest (the norms' ``rsqrt``),
    ``none`` recomputes nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            self.ops[name] = self.ops.get(name, 0) + 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in ("none", "full", "dots"):
        jcfg, _ = ref_model("tinyllama_1_1b")
        model = port_model(jcfg.replace(remat=remat)).requires_grad_(True)
        init_train_state(model, adamw(1e-3),
                         torch.Generator().manual_seed(0))
        _, pb = batches(jcfg)
        out = model.hidden(pb).float().sum()
        with Count() as c:
            torch.autograd.grad(out, list(model.parameters()),
                                allow_unused=True)
        counts[remat] = c.ops
    mm = {k: v.get("mm", 0) for k, v in counts.items()}
    rsqrt = {k: v.get("rsqrt", 0) for k, v in counts.items()}
    assert mm["dots"] == mm["none"] < mm["full"]
    assert rsqrt["none"] < rsqrt["dots"] == rsqrt["full"]


# ----------------------------------- test_train_substrate.py on the port
@pytest.fixture(scope="module")
def tiny():
    cfg = interop.lm_config_from_fields(dataclasses.asdict(
        ref_get_smoke("tinyllama_1_1b").replace(ce_seq_chunk=16)))
    return cfg, build_model(cfg, "cpu")


def rand_batch(cfg, b=4, s=32, seed=0):
    return batches(cfg, b, s, seed)[1]


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_port_chunked_ce_matches_naive(tiny):
    cfg, model = tiny
    state = init_train_state(model, adamw(1e-3), gen())
    batch = rand_batch(cfg)
    with torch.no_grad():
        loss, _ = loss_fn(model, state.params, batch)
        logits = model.logits(batch)
    logp = torch.log_softmax(torch.where(
        torch.arange(cfg.padded_vocab)[None, None] < cfg.vocab_size,
        logits, torch.full_like(logits, -1e30)), -1)
    naive = -torch.gather(logp, -1, batch["labels"][..., None]).mean()
    np.testing.assert_allclose(float(loss), float(naive), rtol=2e-3)


def test_port_loss_decreases(tiny):
    cfg, model = tiny
    opt = adamw(3e-3)
    state = init_train_state(model, opt, gen())
    step = make_train_step(model, opt)
    batch = rand_batch(cfg)
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_port_grad_accumulation_equivalence(tiny):
    """microbatches=2 must match the full-batch gradient step closely."""
    cfg, model = tiny
    opt = adamw(1e-3)
    batch = rand_batch(cfg)
    st1, _ = make_train_step(model, opt, microbatches=1)(
        init_train_state(model, opt, gen()), batch)
    st2, _ = make_train_step(model, opt, microbatches=2)(
        init_train_state(model, opt, gen()), batch)
    for x, y in zip(tree_leaves(st1.params), tree_leaves(st2.params)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=5e-2)


def test_port_adafactor_trains_and_is_lean(tiny):
    cfg, model = tiny
    opt = adafactor(3e-3)
    state = init_train_state(model, opt, gen())
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    n_f32 = sum(v.numel() for v in tree_leaves(state.opt)
                if v.dtype == torch.float32)
    assert n_f32 < 0.25 * n_params
    step = make_train_step(model, opt)
    batch = rand_batch(cfg)
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_port_data_determinism_and_sharding():
    ds0 = SyntheticTokens(1000, 64, 8, seed=1, process_index=0,
                          process_count=2)
    ds1 = SyntheticTokens(1000, 64, 8, seed=1, process_index=1,
                          process_count=2)
    a = ds0.batch(5)
    b = ds0.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])   # determinism
    c = ds1.batch(5)
    assert not np.array_equal(a["tokens"], c["tokens"])       # disjoint
    assert a["tokens"].shape == (4, 64)
    full0 = ds0.batch(7)
    assert (full0["tokens"][:, 1:] == full0["labels"][:, :-1]).all()


def test_port_checkpoint_roundtrip(tmp_path, tiny):
    cfg, model = tiny
    state = init_train_state(model, adamw(1e-3), gen())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, state, blocking=True)
    mgr.save(20, state._replace(step=state.step + 20), blocking=True)
    mgr.save(30, state._replace(step=state.step + 30), blocking=True)
    assert mgr.available_steps() == [20, 30]       # keep=2 gc'd step 10
    restored, step = mgr.restore_latest(like=state)
    assert step == 30
    assert int(restored.step) == 30
    for x, y in zip(tree_leaves(state.params) + tree_leaves(state.opt),
                    tree_leaves(restored.params)
                    + tree_leaves(restored.opt)):
        assert x.dtype == y.dtype
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_restore_waits_for_the_write_in_flight(tmp_path, tiny, monkeypatch):
    """A restore right after a non-blocking save finds that save, however
    slow the write (here: held back until the restore asks)."""
    import threading
    import repro_torch.ckpt.checkpoint as ck
    cfg, model = tiny
    state = init_train_state(model, adamw(1e-3), gen())
    gate = threading.Event()
    real_save = ck.np.save

    def slow_save(*args, **kw):
        gate.wait(10)
        return real_save(*args, **kw)

    monkeypatch.setattr(ck.np, "save", slow_save)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    threading.Timer(0.2, gate.set).start()
    restored, step = mgr.restore_latest(like=state)
    assert step == 2
    assert torch.equal(restored.params["embed"], state.params["embed"])


def test_port_checkpoint_detects_mismatch(tmp_path, tiny):
    cfg, model = tiny
    state = init_train_state(model, adamw(1e-3), gen())
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, like={"different": torch.zeros(3)})


def test_port_supervisor_restarts_from_checkpoint(tmp_path, tiny):
    cfg, model = tiny
    opt = adamw(1e-3)
    state = init_train_state(model, opt, gen())
    step_fn = make_train_step(model, opt)
    ds = SyntheticTokens(cfg.vocab_size, 32, 4, seed=0)
    fail_at = {12}

    def injector(step):
        if step in fail_at:
            fail_at.discard(step)
            return RuntimeError("injected chip failure")
        return None

    sup = Supervisor(
        step_fn=step_fn,
        batch_fn=lambda s: {k: torch.as_tensor(v).long()
                            for k, v in ds.batch(s).items()},
        ckpt=CheckpointManager(str(tmp_path)), ckpt_every=5,
        failure_injector=injector)
    final = sup.run(state, start_step=0, num_steps=20)
    assert int(final.step) == 20
    events = [h["event"] for h in sup.history]
    assert "restart" in events
    steps_run = [h["step"] for h in sup.history if h["event"] == "step"]
    assert steps_run.count(11) == 2


def test_port_straggler_monitor():
    mon = StragglerMonitor(n_hosts=8, evict_after=3)
    times = np.ones(8)
    times[3] = 3.0
    reports = [mon.observe(times) for _ in range(4)]
    assert 3 in reports[-1]["stragglers"]
    assert 3 in reports[-1]["evict"]
    frac = reports[-1]["batch_fractions"]
    assert frac[3] < 1.0 / 8          # slow host gets less work
    np.testing.assert_allclose(frac.sum(), 1.0)


def test_port_int8_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    q, s = comp.int8_compress(g)
    deq = comp.int8_decompress(q, s)
    rel = float(torch.linalg.norm(deq - g) / torch.linalg.norm(g))
    assert rel < 0.02
    res = comp.ErrorFeedback.init({"g": g})
    total = torch.zeros_like(g)
    for _ in range(20):
        c, res = comp.ErrorFeedback.apply({"g": g}, res)
        total = total + c["g"]
    np.testing.assert_allclose((total / 20).numpy(), g.numpy(), atol=1e-3)


# ------------------------------------------------ bit-identical pieces
def test_synthetic_tokens_bit_identical():
    for kw in (dict(seed=0), dict(seed=3, process_index=1, process_count=2,
                                  mean_doc_len=16)):
        ref = RefSyntheticTokens(32000, 96, 8, **kw)
        mine = SyntheticTokens(32000, 96, 8, **kw)
        for step in (0, 1, 17):
            a, b = ref.batch(step), mine.batch(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_int8_codec_and_error_feedback_bit_identical():
    """Both round half to even: ties (x / scale = k + 1/2) included."""
    rng = np.random.default_rng(4)
    cases = [np.array([127, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5], np.float32),
             rng.standard_normal((33, 17)).astype(np.float32) * 1e-3,
             np.zeros(5, np.float32)]
    for x in cases:
        jq, js = ref_comp.int8_compress(jnp.asarray(x))
        q, s = comp.int8_compress(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            comp.int8_decompress(q, s).numpy(),
            np.asarray(ref_comp.int8_decompress(jq, js)))
    g = {"a": rng.standard_normal((16, 8)).astype(np.float32),
         "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, g)
    tg = tree_map(torch.from_numpy, g)
    jr, tr = ref_comp.ErrorFeedback.init(jg), comp.ErrorFeedback.init(tg)
    for _ in range(5):
        jc, jr = ref_comp.ErrorFeedback.apply(jg, jr)
        tc, tr = comp.ErrorFeedback.apply(tg, tr)
        for a, b in zip(tree_leaves(tc) + tree_leaves(tr),
                        jax.tree.leaves(jc) + jax.tree.leaves(jr)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_straggler_monitor_bit_identical():
    rng = np.random.default_rng(5)
    ref, mine = RefStragglerMonitor(6, evict_after=2), StragglerMonitor(
        6, evict_after=2)
    for _ in range(6):
        t = rng.uniform(0.5, 2.0, 6)
        t[rng.integers(6)] *= 3
        a, b = ref.observe(t), mine.observe(t)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))


_SYNC_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.runtime.compression import compressed_grad_sync
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.models.stacking import bind_params
from repro_torch.optim import adamw
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
data = np.load(f"{out}/in.npz")
tree = {"a": torch.from_numpy(data[f"a{rank}"]),
        "b": {"c": torch.from_numpy(data[f"c{rank}"]).bfloat16()}}
res = compressed_grad_sync(tree)
cfg = get_smoke("tinyllama_1_1b").replace(ce_seq_chunk=16)
model = build_model(cfg, "cpu")
opt = adamw(1e-3)
state = init_train_state(model, opt, torch.Generator().manual_seed(0))
ds = SyntheticTokens(cfg.vocab_size, 32, 4, process_index=rank,
                     process_count=2)
batch = {k: torch.as_tensor(v).long() for k, v in ds.batch(0).items()}
step = make_train_step(model, opt, grad_compression="int8_ef",
                       group=dist.group.WORLD)
state, _ = step(state, batch)
np.savez(f"{out}/out{rank}.npz", a=res["a"].numpy(),
         c=res["b"]["c"].float().numpy(),
         params=np.concatenate([p.float().numpy().ravel()
                                for p in tree_leaves(state.params)]))
dist.destroy_process_group()
"""


def test_compressed_grad_sync_over_two_ranks(tmp_path):
    """``compressed_grad_sync`` over a two-rank gloo group equals the
    reference's over a two-member named axis (``jax.vmap``), bit for bit;
    an ``int8_ef`` train step on per-rank batches leaves both ranks with
    equal parameters."""
    rng = np.random.default_rng(6)
    arrays = {f"{k}{r}": rng.standard_normal(shape).astype(np.float32)
              * (r + 1) for r in (0, 1) for k, shape in (("a", (12, 5)),
                                                         ("c", (7,)))}
    np.savez(tmp_path / "in.npz", **arrays)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _SYNC_WORKER, str(r),
                               str(port), str(tmp_path)], env=env,
                              stderr=subprocess.PIPE, text=True)
             for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    want = jax.vmap(lambda g: ref_comp.compressed_grad_sync(g, "pod"),
                    axis_name="pod")({
        "a": jnp.stack([arrays["a0"], arrays["a1"]]),
        "c": jnp.stack([arrays["c0"], arrays["c1"]]).astype(jnp.bfloat16)})
    outs = [np.load(tmp_path / f"out{r}.npz") for r in (0, 1)]
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["a"], np.asarray(want["a"][r]))
        np.testing.assert_array_equal(
            out["c"], np.asarray(want["c"][r].astype(jnp.float32)))
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_checkpoints_read_across(tmp_path, opt_name):
    """Each package restores the other's checkpoint of the same training
    state bit for bit (bf16 as its bit pattern), and both write the same
    manifest."""
    jopt = {"adamw": ref_adamw, "adafactor": ref_adafactor}[opt_name](1e-3)
    jcfg, jm = ref_model("tinyllama_1_1b", "bfloat16")
    jstate = ref_step.init_train_state(jm, jopt, jax.random.PRNGKey(7))
    jstate = jstate._replace(step=jstate.step + 7)
    cfg = port_model(jcfg).cfg
    state = to_port(cfg, jstate)
    CheckpointManager(str(tmp_path / "port")).save(7, state, blocking=True)
    RefCheckpointManager(str(tmp_path / "ref")).save(7, jstate,
                                                     blocking=True)
    manifests = [json.load(open(tmp_path / d / "step_7" / "manifest.json"))
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]

    def bits(x):
        x = np.asarray(x)
        return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x

    back = RefCheckpointManager(str(tmp_path / "port")).restore(7, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))
    mine = CheckpointManager(str(tmp_path / "ref")).restore(7, like=state)
    assert isinstance(mine, TrainState)
    for a, b in zip(tree_leaves(mine), tree_leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_state_interop_roundtrip():
    jcfg, jm = ref_model("mamba2_1_3b", "bfloat16")
    jstate = ref_step.init_train_state(jm, ref_adafactor(1e-3),
                                       jax.random.PRNGKey(8))
    model = port_model(jcfg)
    state = to_port(model.cfg, jstate)
    bind_params(model, state.params)      # every leaf in the model's dtype
    assert state.params["layers"]["mixer"]["a_log"].dtype == torch.float32
    back = interop.train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(back),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jstate._asdict()))):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    bad = jax.tree.map(np.asarray, jstate._asdict())
    bad["params"]["ln_f"]["scale"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        interop.train_state_from_numpy(model.cfg, bad)


# ---------------------------------------------------------------- CLI
def test_cli_smoke_and_resume(tmp_path, capsys):
    launch_train.main(["--arch", "tinyllama-1.1b", "--smoke", "--device",
                       "cpu", "--steps", "3", "--seq", "32", "--batch", "4"])
    out = capsys.readouterr().out
    assert "[train] 3 steps" in out
    ck = str(tmp_path / "ck")
    args = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--steps", "3", "--seq", "32", "--batch", "4", "--ckpt-dir", ck,
            "--ckpt-every", "2"]
    launch_train.main(args)
    launch_train.main(args)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert CheckpointManager(ck).latest_step() == 4


def test_train_function_restart_equals_uninterrupted():
    """The launcher's function with a failure injected at step 3 (the
    newest checkpoint at step 2) ends where an uninterrupted run ends."""
    kw = dict(arch="tinyllama-1.1b", smoke=True, steps=5, seq=32, batch=4,
              device="cpu", optimizer="adafactor", lr=1e-2, warmup=1)
    plain = launch_train.train(**kw)
    hurt = launch_train.train(fail_at=(3,), ckpt_every=2, **kw)
    events = [h["event"] for h in hurt["history"]]
    assert events.count("restart") == 1
    for a, b in zip(tree_leaves(hurt["state"]), tree_leaves(plain["state"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_step_matches_cpu_step(cuda, arch):
    """One smoke training step (float32) on the card against the port's
    CPU step on the same state and batch."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke(arch).replace(param_dtype="float32",
                                  activation_dtype="float32",
                                  ce_seq_chunk=16)
    opt = adamw(1e-3)
    model = build_model(cfg, "cpu")
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    batch = rand_batch(cfg)
    on_card = TrainState(*(tree_map(lambda t: t.to(cuda), part)
                           for part in state))
    cpu_new, cpu_m = make_train_step(model, opt)(state, batch)
    card_new, card_m = make_train_step(build_model(cfg, cuda), opt)(
        on_card, {k: v.to(cuda) for k, v in batch.items()})
    close(card_m["loss"].cpu(), cpu_m["loss"])
    for a, b in zip(tree_leaves(card_new), tree_leaves(cpu_new)):
        close(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_remat_policies_equal(cuda, arch):
    from repro_torch.configs import get_smoke
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = get_smoke(arch).replace(remat=remat, ce_seq_chunk=16)
        model = build_model(cfg, cuda).requires_grad_(True)
        state = init_train_state(model, adamw(1e-3),
                                 torch.Generator(cuda).manual_seed(0))
        batch = {k: v.to(cuda) for k, v in rand_batch(cfg).items()}
        grads[remat] = value_and_grad(model, state.params, batch)[2]
    for remat in ("full", "dots"):
        for a, b in zip(tree_leaves(grads[remat]),
                        tree_leaves(grads["none"])):
            close(a.cpu(), b.cpu(), 2.0 ** -7)


def test_plain_ssd_gradient_stays_finite_where_the_reference_overflows():
    """A kept mismatch: the reference's plain SSD exps every (t, u) pair
    of a chunk, and when the positive exponents above the diagonal
    overflow, its masking ``where`` turns the gradient into NaN (0 *
    inf). The port exps only below the diagonal: the forward is equal,
    the gradient finite (and equal where the reference's is)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L

    rng = np.random.default_rng(9)
    bh, length, p, n, chunk = 2, 64, 4, 3, 32
    x = rng.standard_normal((bh, length, p)).astype(np.float32)
    b = rng.standard_normal((bh, length, n)).astype(np.float32)
    c = rng.standard_normal((bh, length, n)).astype(np.float32)
    a = np.full(bh, -1.0, np.float32)
    for dt_value, overflows in ((0.5, False), (4.0, True)):
        dt = np.full((bh, length), dt_value, np.float32)   # 31 * 4 > 88

        def jloss(dt_):
            return JL._ssd_xla(jnp.asarray(x), dt_, jnp.asarray(a),
                               jnp.asarray(b), jnp.asarray(c), chunk).sum()

        jy = JL._ssd_xla(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
                         jnp.asarray(b), jnp.asarray(c), chunk)
        jg = np.asarray(jax.grad(jloss)(jnp.asarray(dt)))
        tdt = torch.from_numpy(dt).requires_grad_(True)
        ty = L._ssd_xla(torch.from_numpy(x), tdt, torch.from_numpy(a),
                        torch.from_numpy(b), torch.from_numpy(c), chunk)
        (tg,) = torch.autograd.grad(ty.sum(), tdt)
        close(ty, jy)
        assert torch.isfinite(tg).all()
        assert np.isnan(jg).any() == overflows
        if not overflows:
            close(tg, jg)
