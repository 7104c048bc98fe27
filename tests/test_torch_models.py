"""The MoE, VLM, hybrid (RecurrentGemma) and audio (Whisper) families of
the port against the JAX package, at the reference's smoke configs with
``moe_groups=2`` (as the reference's model tests run them), the
reference's weights carried over by ``interop.lm_params_from_numpy``.

Tolerances as in ``test_torch_lm.py``: float32 differs only in summation
order (1e-4); at the bf16 defaults the two packages round at other
places, so a logit may move by 2e-2 of the largest one.
"""
import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import build_model as ref_build_model
from repro.models import layers as JL
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import interop
from repro_torch.configs import get_config, get_smoke, list_archs
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.stacking import stack_params
from repro_torch.serve import ServeEngine

#: one smoke arch per new family (two for MoE: Kimi's leading dense
#: layer and shared expert, Granite's plain top-8)
NEW = ("kimi_k2_1t_a32b", "granite_moe_3b_a800m", "internvl2_2b",
       "recurrentgemma_2b", "whisper_medium")


@functools.lru_cache(maxsize=None)
def ref_params(arch, dtype="float32", seed=0, **over):
    """The reference's smoke weights (the same for either branch)."""
    jcfg = ref_get_smoke(arch).replace(moe_groups=2, param_dtype=dtype,
                                       activation_dtype=dtype, **dict(over))
    return ref_build_model(jcfg).init_params(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def pair(arch, dtype="float32", impl="xla", seed=0, **over):
    """(reference model, its params, port model) on the same weights."""
    jcfg = ref_get_smoke(arch).replace(moe_groups=2, param_dtype=dtype,
                                       activation_dtype=dtype,
                                       attn_impl=impl, **dict(over))
    jm = ref_build_model(jcfg)
    params = ref_params(arch, dtype, seed, **over)
    cfg = interop.lm_config_from_fields(dataclasses.asdict(jcfg))
    model = build_model(cfg, "cpu")
    model.load_state_dict(interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, model


def inputs(cfg, b, s, seed=0):
    """numpy inputs: tokens, and patches or frames where the family takes
    them (at the reference tests' 0.1 scale)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(3, min(200, cfg.vocab_size - 1),
                                  (b, s)).astype(np.int32)}
    if cfg.vlm is not None:
        out["patches"] = (rng.standard_normal(
            (b, cfg.vlm.num_patches, cfg.vlm.d_patch)) * 0.1) \
            .astype(np.float32)
    if cfg.encdec is not None:
        out["frames"] = (rng.standard_normal(
            (b, cfg.encdec.encoder_seq, cfg.encdec.d_frame)) * 0.1) \
            .astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jitted(fn):
    """The reference's function under ``jax.jit`` (a compile, then one
    dispatch; eager JAX takes seconds a call at these sizes)."""
    return jax.jit(fn)


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.as_tensor(v).long() if k == "tokens"
            else torch.as_tensor(v) for k, v in batch.items()}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


def layer0(params, group):
    return jax.tree.map(lambda a: a[0], params[group])


def hidden_in(cfg, b=2, s=12, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    """f32 mean and variance, cast to x's dtype, then scale and bias in
    x's dtype: bit for bit in bf16."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + rng.standard_normal(64) * 0.5).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JL.layer_norm(jnp.asarray(x).astype(jdt),
                         {"scale": jnp.asarray(scale).astype(jdt),
                          "bias": jnp.asarray(bias).astype(jdt)})
    norm = L.LayerNorm(64, tdt, "cpu")
    norm.scale.copy_(torch.as_tensor(scale))
    norm.bias.copy_(torch.as_tensor(bias))
    got = L.layer_norm(torch.as_tensor(x).to(tdt), norm)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np32(got), np32(want))
    else:
        close(got, want, 1e-5)


def moe_layer(model):
    return model.moe_layers[0].moe


@pytest.mark.parametrize("arch", ["kimi_k2_1t_a32b", "granite_moe_3b_a800m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_matches_reference(arch, dtype):
    """The grouped dispatch (stable sort, per-expert slots, the spare
    row), the batched experts, the combine and the shared expert."""
    jm, params, model = pair(arch, dtype)
    x = hidden_in(model.cfg, b=2, s=24, seed=4)
    tdt = getattr(torch, dtype)
    want = jax.jit(lambda p, v: JL.moe(p, v, jm.cfg))(
        layer0(params, "moe_layers")["moe"],
        jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = L.moe(moe_layer(model), torch.as_tensor(x).to(tdt), model.cfg)
    assert got.dtype == tdt
    if dtype == "float32":
        close(got, want, 1e-5)
    else:
        scale = float(np.abs(np32(want)).max())
        np.testing.assert_allclose(np32(got), np32(want),
                                   atol=2e-2 * scale, rtol=2e-2)


def test_moe_drops_past_capacity():
    """A router that sends every token to expert 0 first (by a margin of
    ~10 logits, no ties): each group's expert 0 takes C entries, in
    token order, and drops the rest into the spare row, in both
    packages alike; the dropped tokens keep only their other choice's
    small share."""
    jm, params, model = pair("granite_moe_3b_a800m")
    lp = jax.tree.map(np.asarray, layer0(params, "moe_layers")["moe"])
    router = np.array(lp["router"])
    router[:, 0] = 0.2                     # expert 0 wins every token
    lp = dict(lp, router=router)
    mod = moe_layer(model)
    saved = mod.router.clone()
    mod.router.copy_(torch.as_tensor(router))
    try:
        x = np.abs(hidden_in(model.cfg, b=2, s=16, seed=5)) + 0.1
        cfg = model.cfg
        g, tl, cap = L.moe_capacity(cfg, 32)
        assert (g, tl, cap) == (2, 16, 10)    # 16 tokens a group > C
        want = jax.jit(lambda p, v: JL.moe(p, v, jm.cfg))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
        got = L.moe(mod, torch.as_tensor(x), cfg)
        close(got, want, 1e-5)
        # the tokens past C in a group differ from an uncapped dispatch
        wide = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   capacity_factor=10.0))
        full = L.moe(mod, torch.as_tensor(x), wide)
        differs = (got - full).abs().amax(-1).reshape(g, tl) > 1e-4
        assert differs[:, :cap].sum() == 0
        assert differs[:, cap:].all()
    finally:
        mod.router.copy_(saved)


def rglru_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.hybrid.lru_width)).astype(np.float32)


@pytest.mark.parametrize("mode,s", [("scan", 40), ("one_step", 1)])
def test_rglru_matches_reference(mode, s):
    """The scan (no state, S > 1) against ``associative_scan``; one
    decode step from a state."""
    jm, params, model = pair("recurrentgemma_2b")
    x = hidden_in(model.cfg, s=s, seed=6)
    lp = layer0(params, "groups")["r1"]["mix"]
    st = None if mode == "scan" else rglru_state(model.cfg, 2, 7)
    wy, ws = jax.jit(lambda p, v, h: JL.rglru(p, v, jm.cfg, h))(
        lp, jnp.asarray(x), None if st is None else jnp.asarray(st))
    gy, gs = L.rglru(model.groups[0].r1.mix, torch.as_tensor(x), model.cfg,
                     None if st is None else torch.as_tensor(st))
    close(gy, wy, 1e-5)
    close(gs, ws, 1e-5)


def test_rglru_with_state_steps_every_position_from_it():
    """The reference behaviour, pinned: a call with a state and S > 1
    applies h = a state + x at every position (each from the incoming
    state, not from the position before), in both packages; it is not
    the scan continued from that state."""
    jm, params, model = pair("recurrentgemma_2b")
    cfg = model.cfg
    x = torch.as_tensor(hidden_in(cfg, s=6, seed=8))
    st = rglru_state(cfg, 2, 9)
    mix = model.groups[0].r1.mix
    lp = layer0(params, "groups")["r1"]["mix"]
    wy, ws = jax.jit(lambda p, v, h: JL.rglru(p, v, jm.cfg, h))(
        lp, jnp.asarray(x.numpy()), jnp.asarray(st))
    gy, gs = L.rglru(mix, x, cfg, torch.as_tensor(st))
    close(gy, wy, 1e-5)
    close(gs, ws, 1e-5)
    for t in range(6):
        one, _ = L.rglru(mix, x[:, t:t + 1], cfg, torch.as_tensor(st))
        close(gy[:, t:t + 1], one, 1e-6)
    chained, _ = L.rglru(mix, x[:, 1:2], cfg, L.rglru(mix, x[:, :1], cfg,
                                                      torch.as_tensor(st))[1])
    assert not torch.allclose(gy[:, 1:2], chained, atol=1e-3)


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the sequential loop, in float64, at a
    length that is not a power of two."""
    rng = np.random.default_rng(10)
    a = torch.as_tensor(rng.uniform(0.1, 1.0, (3, 37, 5)))
    b = torch.as_tensor(rng.standard_normal((3, 37, 5)))
    h, want = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(L.linear_scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("s", [1, 37, 64])
def test_linear_scan_backward_is_the_reverse_recurrence(s):
    """The scan's own backward (the reverse recurrence, one more doubling
    scan) against autograd through the sequential loop, in float64."""
    rng = np.random.default_rng(11 + s)
    a = torch.as_tensor(rng.uniform(0.1, 1.0, (3, s, 5))).requires_grad_()
    b = torch.as_tensor(rng.standard_normal((3, s, 5))).requires_grad_()
    w = torch.as_tensor(rng.standard_normal((3, s, 5)))
    got = torch.autograd.grad((L.linear_scan(a, b) * w).sum(), (a, b))
    h, hs = torch.zeros(3, 5, dtype=torch.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    want = torch.autograd.grad((torch.stack(hs, 1) * w).sum(), (a, b))
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-12, atol=1e-12)


def test_large_draws_take_slices_of_the_seed(monkeypatch):
    """A tensor past ``DRAW_ELEMENTS`` is drawn in leading-axis slices:
    the same values for the same seed, each slice the next draw of the
    generator; a smaller tensor is one draw, as before."""
    monkeypatch.setattr(L, "DRAW_ELEMENTS", 64)
    big = torch.empty((10, 4, 5))
    L._normal_(big, 0.5, torch.Generator().manual_seed(3))
    again = torch.empty((10, 4, 5))
    L._normal_(again, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(big, again)
    gen = torch.Generator().manual_seed(3)
    parts = [torch.randn((n, 4, 5), generator=gen) * 0.5 for n in (3, 3, 3,
                                                                   1)]
    assert torch.equal(big, torch.cat(parts))
    small = torch.empty((3, 4, 5))
    L._normal_(small, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(small, torch.randn(
        (3, 4, 5), generator=torch.Generator().manual_seed(3)) * 0.5)


# ------------------------------------------------------------------ models
#: a router near-tie: a token's k-th and (k+1)-th gates closer than this.
#: At bf16 the two packages' hidden states differ by an ulp (2^-8
#: relative) here and there, which moves a smoke router's gates by up to
#: ~1e-3: at a near-tie the token may take another expert in one package,
#: which changes it and, through attention and its group's capacity, the
#: positions after it in its sequence (Granite's smoke at S 40: a margin
#: of 3.6e-4, two positions 0.57 apart of a largest logit of 3.8)
NEAR_TIE = 1e-3


def after_near_ties(model, batch, monkeypatch):
    """(B, S) bool: the positions at or after a token whose routing in the
    port has a near-tie in some MoE layer (the port's forward, spied)."""
    b, s = batch["tokens"].shape
    ties = torch.zeros((b, s), dtype=torch.bool)
    plain_moe = L.moe

    def spy(p, x, cfg):
        gates = torch.softmax(x.float() @ p.router, dim=-1)
        top = torch.topk(gates, cfg.moe.top_k + 1, dim=-1).values
        ties.logical_or_(top[..., -2] - top[..., -1] < NEAR_TIE)
        return plain_moe(p, x, cfg)

    monkeypatch.setattr(L, "moe", spy)
    with torch.inference_mode():
        model.logits(tbatch(batch))
    monkeypatch.setattr(L, "moe", plain_moe)
    return torch.cummax(ties.int(), dim=1).values.bool().numpy()


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_reference(arch, impl, dtype, monkeypatch):
    """Port "plain" vs JAX "xla", port "kernel" (plain versions on the
    CPU) vs JAX "pallas" (interpret mode), with patches or frames where
    the family takes them; the CPU launches no kernel. In bf16 an MoE
    model's positions from a router near-tie on (``NEAR_TIE``) may route
    apart and are left out, at most a quarter of them; in float32 none
    is."""
    jm, params, model = pair(arch, dtype, impl)
    batch = inputs(model.cfg, 2, 40)
    want = np.asarray(jitted(jm.logits)(params, jbatch(batch)))
    build.reset_launch_counts()
    with torch.inference_mode():
        got = model.logits(tbatch(batch))
    assert not any(build.LAUNCHES.values())
    assert got.dtype == torch.float32
    assert got.shape == (2, 40, model.cfg.padded_vocab)
    if dtype == "float32":
        close(got, want, 1e-4)
        return
    keep = np.ones((2, 40), bool)
    if model.cfg.family == "moe":
        keep = ~after_near_ties(model, batch, monkeypatch)
        assert keep.mean() >= 0.75
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy()[keep], want[keep],
                               atol=2e-2 * scale, rtol=2e-2)


#: teacher forcing: (arch, prefill tokens, total tokens, cache length).
#: The RecurrentGemma cases prefill past its window of 32 (a rolled
#: cache) and decode across the wrap
FORCING = [
    ("kimi_k2_1t_a32b", 4, 10, 32),
    ("granite_moe_3b_a800m", 4, 10, 32),
    ("internvl2_2b", 4, 10, 32),
    ("recurrentgemma_2b", 4, 10, 64),
    ("recurrentgemma_2b", 36, 44, 64),
    ("whisper_medium", 4, 10, 32),
]


@pytest.mark.parametrize("arch,pre,total,max_seq", FORCING)
def test_prefill_decode_matches_full_forward(arch, pre, total, max_seq):
    """Prefill ``pre`` tokens (with the patches or frames), then decode
    one at a time: each step's logits equal the full forward's at that
    position, and the reference's own step logits; the cache index
    advances as the reference's. MoE capacity is lifted so that the full
    forward (20 tokens) and a decode step (2) drop nothing and can
    agree."""
    moe = ref_get_smoke(arch).moe
    over = {} if moe is None else {
        "moe": dataclasses.replace(moe, capacity_factor=100.0)}
    jm, params, model = pair(arch, **over)
    b = 2
    batch = inputs(model.cfg, b, total, seed=3)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    tok = batch["tokens"]
    with torch.inference_mode():
        full = model.logits(tbatch(batch))
        cache, jcache = model.init_cache(b, max_seq), jm.init_cache(b,
                                                                    max_seq)
        first = {"tokens": tok[:, :pre], **extra}
        lp, cache = model.prefill(cache, tbatch(first))
        jlp, jcache = jitted(jm.prefill)(params, jcache, jbatch(first))
        close(lp[:, 0], full[:, pre - 1], 1e-4)
        close(lp, jlp, 1e-4)
        for t in range(pre, total):
            step = {"tokens": tok[:, t:t + 1]}
            ld, cache = model.decode_step(cache, tbatch(step))
            jld, jcache = jitted(jm.decode_step)(params, jcache,
                                                 jbatch(step))
            close(ld[:, 0], full[:, t], 1e-4)
            close(ld, jld, 1e-4)
    assert cache["index"] == int(jcache["index"])


def test_whisper_positions_past_max_seq_read_nan():
    """The reference behaviour, pinned: Whisper's decoder positions come
    from ``dec_pos`` (``max_seq`` rows) by ``jnp.take``, which fills rows
    past the end with NaN; the port gives the same logits, finite at the
    last position and NaN past it (never an out-of-range index on the
    card)."""
    jm, params, model = pair("whisper_medium")
    last = model.cfg.max_seq - 1
    batch = inputs(model.cfg, 2, 1, seed=6)
    with torch.inference_mode():
        cache, jcache = model.init_cache(2, 16), jm.init_cache(2, 16)
        _, cache = model.prefill(cache, tbatch(batch))
        _, jcache = jitted(jm.prefill)(params, jcache, jbatch(batch))
        cache["index"], jcache["index"] = last, jnp.int32(last)
        for _ in range(2):
            step = {"tokens": batch["tokens"]}
            got, cache = model.decode_step(cache, tbatch(step))
            want, jcache = jitted(jm.decode_step)(params, jcache,
                                                  jbatch(step))
            finite = bool(np.isfinite(np.asarray(want)).all())
            assert finite == (int(jcache["index"]) <= last + 1)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", list_archs())
def test_smoke_forward_every_arch(arch):
    """Every arch's smoke config builds on the CPU and scores: finite
    float32 logits of (B, S, padded vocab), with patches or frames where
    the family takes them."""
    cfg = get_smoke(arch)
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = model.logits(tbatch(inputs(cfg, 2, 12)))
    assert out.dtype == torch.float32
    assert out.shape == (2, 12, cfg.padded_vocab)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("arch", NEW)
def test_serve_engine_tokens_equal_reference(arch):
    """Greedy tokens of the slot engine, equal to the reference's on the
    float32 smoke config: 5 prompts of 3-11 tokens in batches of 2 (the
    last short), patches or frames as ``extra_inputs``. RecurrentGemma's
    cache of 16 is shorter than its window, so the rolling cache wraps."""
    jm, params, model = pair(arch)
    from repro_torch.launch.serve import make_prompts
    prompts = make_prompts(model.cfg.vocab_size, 5)
    extra = {k: v for k, v in inputs(model.cfg, 2, 1, seed=4).items()
             if k != "tokens"} or None
    max_seq = 16 if arch == "recurrentgemma_2b" else 32
    want = RefServeEngine(jm, params, batch_size=2,
                          max_seq=max_seq).generate(
        prompts, max_new_tokens=6,
        extra_inputs=None if extra is None else jbatch(extra))
    got = ServeEngine(model, batch_size=2, max_seq=max_seq).generate(
        prompts, max_new_tokens=6, extra_inputs=extra)
    assert got == want
    assert all(len(o) >= 1 for o in got)


@pytest.mark.parametrize("arch", NEW)
def test_params_round_trip(arch):
    """``lm_params_from_numpy`` carries the reference's tree in bit for
    bit (bf16 through float32), and ``stack_params`` gives the same tree
    back, key for key (RecurrentGemma's nested groups included)."""
    jm, params, model = pair(arch, "bfloat16")
    want = dict(interop._flatten(jax.tree.map(np.asarray, params)))
    back = stack_params(model)
    got = dict(interop._flatten(back))
    assert got.keys() == want.keys()
    for key, arr in want.items():
        assert got[key].dtype == model.cfg.pdtype or key.endswith(
            ("router", "lam"))
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      np.asarray(arr, np.float32), key)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list_archs())
def test_full_param_tree_matches_reference(arch):
    """The FULL model built on the meta device has the reference's
    parameter tree: every key, shape and dtype (``jax.eval_shape``, no
    memory on either side)."""
    jm = ref_build_model(ref_get_config(arch))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in interop._flatten(shapes)}
    model = build_model(get_config(arch), "meta")
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in interop._flatten(stack_params(model))}
    assert got == want
    assert get_smoke(arch).family == get_config(arch).family


def test_unknown_family_raises():
    cfg = get_smoke("tinyllama-1.1b").replace(family="nope")
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(cfg, "cpu")


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["internvl2-2b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_serve_launcher_matches_reference(arch, capsys, monkeypatch):
    """Both launchers pass no patches and no frames: InternVL2 and
    RecurrentGemma serve text, every request printed (the weights
    differ: jax.random against torch.Generator); Whisper cannot be served by either (its prefill needs ``frames``:
    ``KeyError``), a reference behaviour the port keeps."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "3"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    if arch == "whisper-medium":
        with pytest.raises(KeyError, match="frames"):
            ref_serve.main()
        with pytest.raises(KeyError, match="frames"):
            serve.main(argv + ["--device", "cpu"])
        return
    ref_serve.main()
    want = capsys.readouterr().out
    serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    for out in (want, got):
        assert "[serve] 3 requests" in out
        assert [line.split(":")[0].strip() for line in
                out.splitlines()[1:]] == ["req0", "req1", "req2"]
