"""Training of the MoE, VLM, hybrid (RecurrentGemma) and audio (Whisper)
families in the port against the JAX package, at the smoke configs with
``moe_groups=2`` (as the reference's launcher sets it), the reference's
state carried over by ``interop.train_state_from_numpy``.

Tolerances as in ``test_torch_train.py``: in float32 the two packages
differ only in summation order, so loss, accuracy, every gradient and
each optimizer step agree within rtol 1e-4 (an element near zero is
held to 1e-4 of its leaf's largest magnitude; a bf16 leaf, Adafactor's
first moment, within one bf16 ulp; carried over three steps, that leaf
within ``CARRIED_BF16_MOMENT``). The MoE configs run with the
capacity lifted to every token of a group, so that neither package
drops a token; no router choice sits within ``F32_TIE`` of flipping,
which the test checks, so both route alike.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro.configs import get_smoke as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.optim import adafactor as ref_adafactor
from repro.optim import adamw as ref_adamw
from repro.optim import cosine_schedule as ref_cosine
from repro.train import step as ref_step
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import adafactor, adamw, cosine_schedule
from repro_torch.train.step import (TrainState, init_train_state,
                                    make_train_step, value_and_grad)
from repro_torch.tree import tree_items, tree_leaves
from test_torch_train import close, close_trees, port_model, to_port

#: (arch, the batch's extra input): InternVL2 with and without patches
#: (the reference trains text alone when the batch has none), Whisper
#: with frames
CASES = [("granite_moe_3b_a800m", None), ("kimi_k2_1t_a32b", None),
         ("internvl2_2b", "patches"), ("internvl2_2b", None),
         ("recurrentgemma_2b", None), ("whisper_medium", "frames")]
#: a router margin below this may flip a top-k choice between the
#: packages in float32, whose gates differ by summation order only
#: (~1e-7); ``NEAR_TIE`` of ``test_torch_models.py`` (1e-3) is bf16's
F32_TIE = 1e-5


def lifted(jcfg):
    """The MoE config with every expert's capacity at a group's tokens."""
    if jcfg.moe is None:
        return jcfg
    m = jcfg.moe
    return jcfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def ref_model(arch, dtype="float32", **over):
    jcfg = lifted(ref_get_smoke(arch).replace(
        param_dtype=dtype, activation_dtype=dtype, ce_seq_chunk=16,
        moe_groups=2, **over))
    return jcfg, ref_build_model(jcfg)


def batches(cfg, extra, b=2, s=32, seed=0):
    """numpy tokens and labels, and the extra input, at the reference
    tests' 0.1 scale; as the reference's and the port's batches."""
    rng = np.random.default_rng(seed)
    t = rng.integers(3, cfg.vocab_size - 1, (b, s + 1)).astype(np.int32)
    out = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if extra == "patches":
        out["patches"] = (rng.standard_normal(
            (b, cfg.vlm.num_patches, cfg.vlm.d_patch)) * 0.1) \
            .astype(np.float32)
    if extra == "frames":
        out["frames"] = (rng.standard_normal(
            (b, cfg.encdec.encoder_seq, cfg.encdec.d_frame)) * 0.1) \
            .astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in out.items()}
    p = {k: torch.as_tensor(v).long() if k in ("tokens", "labels")
         else torch.as_tensor(v) for k, v in out.items()}
    return j, p


def no_near_ties(model, batch, monkeypatch):
    """Check that no router choice of the port's forward on ``batch`` sits
    within ``F32_TIE`` of flipping (MoE models; others pass)."""
    if model.cfg.moe is None:
        return
    margins = []
    plain_moe = L.moe

    def spy(p, x, cfg):
        gates = torch.softmax(x.float() @ p.router, dim=-1)
        top = torch.topk(gates, cfg.moe.top_k + 1, dim=-1).values
        margins.append(float((top[..., -2] - top[..., -1]).min()))
        return plain_moe(p, x, cfg)

    monkeypatch.setattr(L, "moe", spy)
    with torch.no_grad():
        model.hidden(batch)
    monkeypatch.setattr(L, "moe", plain_moe)
    assert margins and min(margins) >= F32_TIE, margins


# ------------------------------------------------------ loss and grads
@pytest.mark.parametrize("arch,extra", CASES)
def test_loss_and_grads_match_reference(arch, extra, monkeypatch):
    """Loss, accuracy and every gradient against ``jax.value_and_grad``
    in float32 (the gradient tree in the reference's stacked layout):
    the MoE dispatch and its router under autograd, the VLM's patches,
    the RG-LRU's scan (its backward the reverse recurrence), Whisper's
    encoder over the frames."""
    jcfg, jm = ref_model(arch)
    jstate = ref_step.init_train_state(jm, ref_adamw(1e-3),
                                       jax.random.PRNGKey(0))
    jb, pb = batches(jcfg, extra)
    (jl, jmx), jg = jax.value_and_grad(
        lambda p: ref_step.loss_fn(jm, p, jb), has_aux=True)(jstate.params)
    model = port_model(jcfg).requires_grad_(True)
    state = to_port(model.cfg, jstate)
    loss, mx, g = value_and_grad(model, state.params, pb)
    no_near_ties(model, pb, monkeypatch)
    close(loss, jl)
    close(mx["accuracy"], jmx["accuracy"])
    close_trees(g, jg)
    if model.cfg.moe is not None:
        router = [k for k, _ in tree_items(g) if k.endswith("router")]
        assert router and all(dict(tree_items(g))[k].abs().max() > 0
                              for k in router)


@pytest.fixture
def flushed_subnormals():
    """PyTorch's CPU float ops flush subnormals to zero for the test (XLA's
    CPU backend does; PyTorch does not by default)."""
    assert torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


#: Adafactor's bf16 first moment after three carried steps: within this
#: share of its leaf's largest magnitude (measured: 0.35% at most)
CARRIED_BF16_MOMENT = 2.0 ** -7


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m",
                                  "recurrentgemma_2b", "whisper_medium"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_train_steps_match_reference(arch, name, flushed_subnormals):
    """Three steps of ``make_train_step`` (AdamW or Adafactor, a cosine
    rate peaking at 1e-3).

    Each step taken from the reference's state before it gives every
    parameter and optimizer leaf of the reference's step. Carried on
    its own state, the port gives the loss of every step, and after the
    first and the last the parameters and every float32 optimizer leaf.
    Adafactor's bf16 first moment, carried, is held to
    ``CARRIED_BF16_MOMENT`` of its leaf's largest magnitude after the
    third step: the packages' gradients differ by summation order, the
    factored preconditioner divides each element by its own row's and
    column's scale (so an element of a small row carries an error large
    against it), and the bf16 rounding of the moment keeps each step's
    difference for the next.

    The port steps with subnormal floats flushed to zero, as XLA's CPU
    backend computes: Adafactor's factored denominator of an embedding
    row whose gradient is ~1e-12 is a subnormal product, which a flush
    sends to its eps clamp, and without one the row's update differs by
    a share of the rate."""
    make = {"adamw": (ref_adamw, adamw),
            "adafactor": (ref_adafactor, adafactor)}[name]
    jopt = make[0](ref_cosine(1e-3, 1, 3))
    opt = make[1](cosine_schedule(1e-3, 1, 3))
    extra = "frames" if arch == "whisper_medium" else None
    jcfg, jm = ref_model(arch)
    jstate = ref_step.init_train_state(jm, jopt, jax.random.PRNGKey(1))
    model = port_model(jcfg)
    state = to_port(model.cfg, jstate)
    jstep = jax.jit(ref_step.make_train_step(jm, jopt))
    step = make_train_step(model, opt)
    for i in range(3):
        jb, pb = batches(jcfg, extra, seed=10 + i)
        alone, _ = step(to_port(model.cfg, jstate), pb)
        jstate, jmx = jstep(jstate, jb)
        state, mx = step(state, pb)
        close_trees(alone.params, jstate.params)
        close_trees(alone.opt, jstate.opt)
        close(mx["loss"], jmx["loss"])
        if i in (0, 2):
            close_trees(state.params, jstate.params)
            got = list(tree_items(state.opt))
            assert [k for k, _ in got] == [
                k for k, _ in tree_items(jax.tree.map(lambda _: 0,
                                                      jstate.opt))]
            for (key, a), b in zip(got, jax.tree.leaves(jstate.opt)):
                close(a, b, CARRIED_BF16_MOMENT
                      if a.dtype == torch.bfloat16 else 1e-4)
    assert int(state.step) == int(jstate.step) == 3


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_rglru_remat_policies_equal(remat):
    """The RG-LRU's own backward under the remat policies the FULL hybrid
    config trains with: the gradients equal those without remat, bit for
    bit."""
    grads = {}
    for policy in ("none", remat):
        jcfg, _ = ref_model("recurrentgemma_2b", remat=policy)
        model = port_model(jcfg).requires_grad_(True)
        state = init_train_state(model, adamw(1e-3),
                                 torch.Generator().manual_seed(0))
        grads[policy] = value_and_grad(model, state.params,
                                       batches(jcfg, None)[1])[2]
    for a, b in zip(tree_leaves(grads[remat]), tree_leaves(grads["none"])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ launcher
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "kimi-k2-1t-a32b",
                                  "internvl2-2b", "recurrentgemma-2b"])
def test_launcher_trains_every_family(arch):
    """``launch.train.train`` on the smoke config (``SyntheticTokens``,
    no patches: the VLM trains on text, as the reference's launcher
    does): finite losses that fall over 8 steps."""
    out = launch_train.train(arch, steps=8, smoke=True, seq=32, batch=4,
                             device="cpu", warmup=1)
    losses = [h["metrics"]["loss"] for h in out["history"]
              if h["event"] == "step"]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert min(losses[4:]) < losses[0]


def test_whisper_launchers_need_frames(tmp_path, monkeypatch):
    """Neither launcher gives Whisper frames (``SyntheticTokens`` makes
    tokens only): both raise ``KeyError: 'frames'``, a reference
    behaviour the port keeps; the step itself trains Whisper with frames
    (above)."""
    from repro.launch import train as ref_train
    argv = ["--arch", "whisper-medium", "--smoke", "--steps", "1", "--seq",
            "16", "--batch", "2", "--ckpt-dir", str(tmp_path / "ref")]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(KeyError, match="frames"):
        ref_train.main()
    with pytest.raises(KeyError, match="frames"):
        launch_train.main(argv[:-2] + ["--device", "cpu"])
    model = build_model(get_smoke("whisper-medium"), "cpu")
    init_train_state(model, adamw(1e-3), torch.Generator().manual_seed(0))
    with pytest.raises(KeyError, match="frames"):
        make_train_step(model, adamw(1e-3))(
            init_train_state(model, adamw(1e-3),
                             torch.Generator().manual_seed(0)),
            {"tokens": torch.zeros((2, 8), dtype=torch.long),
             "labels": torch.zeros((2, 8), dtype=torch.long)})


# --------------------------------------------------------- checkpoints
def test_moe_checkpoints_read_across(tmp_path):
    """Each package restores the other's checkpoint of a Kimi K2 smoke
    training state (its dense layer, MoE layers, shared expert and
    Adafactor's factored moments) bit for bit, bf16 as its bit pattern;
    both write the same manifest."""
    jopt = ref_adafactor(1e-3)
    jcfg, jm = ref_model("kimi_k2_1t_a32b", "bfloat16")
    jstate = ref_step.init_train_state(jm, jopt, jax.random.PRNGKey(7))
    jstate = jstate._replace(step=jstate.step + 5)
    cfg = port_model(jcfg).cfg
    state = to_port(cfg, jstate)
    CheckpointManager(str(tmp_path / "port")).save(5, state, blocking=True)
    RefCheckpointManager(str(tmp_path / "ref")).save(5, jstate,
                                                     blocking=True)
    manifests = [json.load(open(tmp_path / d / "step_5" / "manifest.json"))
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]

    def bits(x):
        x = np.asarray(x)
        return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x

    back = RefCheckpointManager(str(tmp_path / "port")).restore(5, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(bits(a), bits(b))
    mine = CheckpointManager(str(tmp_path / "ref")).restore(5, like=state)
    assert isinstance(mine, TrainState)
    for a, b in zip(tree_leaves(mine), tree_leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)
