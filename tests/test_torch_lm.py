"""The LM substrate's forward path (``repro_torch.models``, the serving
engine, the configs and the parameter interop) against the JAX package,
at the smoke configs, with the reference's weights carried over by
``interop.lm_params_from_numpy``.

Tolerances: with float32 parameters and activations the two packages
differ only in summation order (1e-4). At the bf16 defaults they round
at other places (a silu or a matmul accumulation one bf16 ulp apart), and
the logits themselves are bf16 matmul outputs, so a logit can move by an
ulp of the largest one: 2e-2 relative to the largest logit.
"""
import dataclasses
import functools

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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.config import MoEConfig, VLMConfig
from repro_torch.serve import ServeEngine

ARCHS = ("tinyllama_1_1b", "mamba2_1_3b")
IMPLS = {"xla": "plain", "pallas": "kernel"}


@functools.lru_cache(maxsize=None)
def pair(arch, dtype="bfloat16", impl="xla", seed=0):
    """(reference model, its params, port model) on the same weights."""
    jcfg = ref_get_smoke(arch).replace(param_dtype=dtype,
                                       activation_dtype=dtype,
                                       attn_impl=impl)
    jm = ref_build_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(seed))
    cfg = interop.lm_config_from_fields(dataclasses.asdict(jcfg))
    model = build_model(cfg, "cpu")
    model.load_state_dict(interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    return jm, params, model


def tokens(b, s, seed=0, vocab=200):
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab, (b, s)).astype(np.int32)


def np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def layer0(params, group):
    return jax.tree.map(lambda a: a[0], params[group])


def close(got, want, tol):
    np.testing.assert_allclose(np32(got), np32(want), atol=tol, rtol=tol)


# ------------------------------------------------------------------ blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    """Normalise in f32, cast to x's dtype, then scale in x's dtype: in
    bf16 the port must equal the reference bit for bit (scaling in f32
    would round differently)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3
    scale = (1 + rng.standard_normal(64) * 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = JL.rms_norm(jx, {"scale": jnp.asarray(scale).astype(dtype)})
    norm = L.RMSNorm(64, getattr(torch, dtype), "cpu")
    norm.scale.copy_(torch.as_tensor(scale))
    got = L.rms_norm(torch.as_tensor(x).to(getattr(torch, dtype)), norm)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(np32(got), np32(want))
    else:
        close(got, want, 1e-6)


def test_rope_concatenated_halves():
    """Rotated halves (not interleaved pairs), f32 angles, at positions
    up to the TinyLlama context (where the two libraries' f32 sin/cos
    of the same angle differ by ~2e-5)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9))
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = L.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    close(got, want, 1e-4)


def attn_inputs(cfg, b=2, s=12, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_attention_uncached(impl):
    """GQA (4 q heads on 2 kv heads: kv head h // 2 serves q head h)."""
    jm, params, model = pair("tinyllama_1_1b", "float32", impl)
    x = attn_inputs(model.cfg)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    want, _ = JL.attention(layer0(params, "dense_layers")["attn"],
                           jnp.asarray(x), jm.cfg, jnp.asarray(pos))
    got, _ = L.attention(model.dense_layers[0].attn, torch.as_tensor(x),
                         model.cfg, torch.as_tensor(pos))
    close(got, want, 1e-4)


@pytest.mark.parametrize("idx", [0, 5])
def test_attention_cached(idx):
    """Prefill/decode into a cache at ``idx``: output and both caches."""
    jm, params, model = pair("tinyllama_1_1b", "float32")
    cfg = model.cfg
    rng = np.random.default_rng(3)
    shape = (2, cfg.kv_heads, 16, cfg.hd)
    kc, vc = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    x = attn_inputs(cfg, s=3)
    pos = idx + np.broadcast_to(np.arange(3), (2, 3))
    want, (jk, jv, jidx) = JL.attention(
        layer0(params, "dense_layers")["attn"], jnp.asarray(x), jm.cfg,
        jnp.asarray(pos), cache=(jnp.asarray(kc), jnp.asarray(vc),
                                 jnp.int32(idx)))
    got, (tk, tv, tidx) = L.attention(
        model.dense_layers[0].attn, torch.as_tensor(x), cfg,
        torch.as_tensor(pos), cache=(torch.as_tensor(kc.copy()),
                                     torch.as_tensor(vc.copy()), idx))
    close(got, want, 1e-4)
    close(tk, jk, 1e-5)
    close(tv, jv, 1e-5)
    assert tidx == int(jidx) == idx + 3


def test_mlp():
    jm, params, model = pair("tinyllama_1_1b", "float32")
    x = attn_inputs(model.cfg)
    want = JL.mlp(layer0(params, "dense_layers")["mlp"], jnp.asarray(x),
                  jm.cfg)
    got = L.mlp(model.dense_layers[0].mlp, torch.as_tensor(x), model.cfg)
    close(got, want, 1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(4)
    seq = rng.standard_normal((2, 6, 10)).astype(np.float32)
    w = rng.standard_normal((4, 10)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 10)).astype(np.float32)
          if with_state else None)
    wo, ws = JL._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    go, gs = L._causal_conv(torch.as_tensor(seq), torch.as_tensor(w),
                            None if st is None else torch.as_tensor(st))
    close(go, wo, 1e-6)
    close(gs, ws, 0)


@pytest.mark.parametrize("l,chunk", [(64, 32), (45, 16)])
def test_ssd_xla(l, chunk):
    """The models' plain chunked SSD and its final state (padded L
    included)."""
    rng = np.random.default_rng(l)
    bh, p, n = 3, 8, 5
    args = ((rng.standard_normal((bh, l, p))).astype(np.float32),
            (0.1 + rng.random((bh, l)) * 0.5).astype(np.float32),
            (-0.5 - rng.random(bh)).astype(np.float32),
            (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32),
            (rng.standard_normal((bh, l, n)) * 0.3).astype(np.float32))
    wy, wh = JL._ssd_xla(*map(jnp.asarray, args), chunk, return_state=True)
    gy, gh = L._ssd_xla(*map(torch.as_tensor, args), chunk,
                        return_state=True)
    close(gy, wy, 1e-5)
    close(gh, wh, 1e-5)


def mixer_state(cfg, b, seed):
    d_in, nh, ph, n = L.ssm_dims(cfg)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nh, ph, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, cfg.ssm.conv_width - 1,
                                 d_in + 2 * n)).astype(np.float32))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode,s", [("stateless", 40), ("prefill", 7),
                                    ("decode", 1)])
def test_mamba2_mixer(impl, mode, s):
    """Stateless (the kernel branch under "pallas"), prefill into a state
    (the reference starts the SSD from zero and carries only the conv
    state: the port reproduces that), and one-token decode."""
    jm, params, model = pair("mamba2_1_3b", "float32", impl)
    x = attn_inputs(model.cfg, s=s, seed=5)
    lp = layer0(params, "layers")["mixer"]
    st = None if mode == "stateless" else mixer_state(model.cfg, 2, 6)
    wy, wst = JL.mamba2(lp, jnp.asarray(x), jm.cfg,
                        None if st is None else tuple(map(jnp.asarray, st)))
    gy, gst = L.mamba2(model.layers[0].mixer, torch.as_tensor(x), model.cfg,
                       None if st is None else tuple(map(torch.as_tensor,
                                                         st)))
    close(gy, wy, 1e-4)
    if st is None:
        assert gst is None and wst is None
    else:
        close(gst[0], wst[0], 1e-4)
        close(gst[1], wst[1], 1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba2_per_head_decay_layout(impl):
    """Per-head ``a_log``, ``dt_bias`` and ``d_skip`` that differ, at
    B 3: ``jnp.tile(a, (b,))`` puts head h of batch i at i*nh + h, which
    is ``a.repeat(b)`` (``repeat_interleave`` would agree only when every
    head is the same, as at init)."""
    jcfg = ref_get_smoke("mamba2_1_3b").replace(
        param_dtype="float32", activation_dtype="float32", attn_impl=impl)
    lp = jax.tree.map(np.asarray, ref_build_model(jcfg).init_params(
        jax.random.PRNGKey(4)))
    lp = jax.tree.map(lambda a: a[0], lp["layers"])["mixer"]
    rng = np.random.default_rng(9)
    nh = lp["a_log"].shape[0]
    for name, lo, hi in (("a_log", -2.0, 1.0), ("dt_bias", -1.0, 1.0),
                         ("d_skip", 0.0, 2.0)):
        lp[name] = rng.uniform(lo, hi, nh).astype(np.float32)
    cfg = interop.lm_config_from_fields(dataclasses.asdict(jcfg))
    mixer = L.Mamba2Mixer(cfg, "cpu")
    mixer.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                           for k, v in interop._flatten(lp)})
    x = attn_inputs(cfg, b=3, s=20, seed=10)
    want, _ = JL.mamba2(jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jcfg)
    got, _ = L.mamba2(mixer, torch.as_tensor(x), cfg)
    close(got, want, 1e-4)


def test_mamba2_prefill_ignores_incoming_ssd_state():
    """The reference quirk, pinned: with s > 1 the incoming h does not
    reach the output, in either package."""
    jm, params, model = pair("mamba2_1_3b", "float32")
    x = torch.as_tensor(attn_inputs(model.cfg, s=5, seed=7))
    h, conv = map(torch.as_tensor, mixer_state(model.cfg, 2, 8))
    mixer = model.layers[0].mixer
    y1, _ = L.mamba2(mixer, x, model.cfg, (h, conv))
    y2, _ = L.mamba2(mixer, x, model.cfg, (torch.zeros_like(h), conv))
    assert torch.equal(y1, y2)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_reference(arch, impl, dtype):
    """Port "plain" vs JAX "xla", port "kernel" (plain versions on the
    CPU) vs JAX "pallas" (interpret mode)."""
    jm, params, model = pair(arch, dtype, impl)
    assert model.cfg.attn_impl == IMPLS[impl]
    tok = tokens(2, 40)
    want = np.asarray(jm.logits(params, {"tokens": jnp.asarray(tok)}))
    build.reset_launch_counts()
    with torch.inference_mode():
        got = model.logits({"tokens": torch.as_tensor(tok).long()})
    assert not any(build.LAUNCHES.values())
    assert got.dtype == torch.float32
    assert got.shape == (2, 40, model.cfg.padded_vocab)
    if dtype == "float32":
        close(got, want, 1e-4)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * scale,
                                   rtol=2e-2)


class _Stop(Exception):
    pass


def _stop():
    raise _Stop


#: narrow, two-layer cuts of the FULL configs with the kernels' shapes
#: (head dim 64, 96 (Phi-3), 112 (Kimi K2's ``head_dim``) or 128; P 64,
#: N 128, chunk 128); the MoE and VLM cuts keep their family's parts
KERNEL_SHAPED = {
    "tinyllama_1_1b": dict(num_layers=2, d_model=256, num_heads=4,
                           kv_heads=2, d_ff=256, vocab_size=256),
    "mamba2_1_3b": dict(num_layers=2, d_model=128, vocab_size=256),
    "phi3_mini_3_8b": dict(num_layers=2, d_model=384, num_heads=4,
                           kv_heads=4, d_ff=256, vocab_size=256),
    "qwen3_14b": dict(num_layers=2, d_model=256, num_heads=4, kv_heads=2,
                      d_ff=256, vocab_size=256),
    "deepseek_coder_33b": dict(num_layers=2, d_model=512, num_heads=4,
                               kv_heads=2, d_ff=256, vocab_size=256),
    "kimi_k2_1t_a32b": dict(
        num_layers=2, d_model=128, num_heads=4, kv_heads=2, d_ff=256,
        vocab_size=256, moe=MoEConfig(num_experts=8, top_k=2,
                                      d_ff_expert=64, first_k_dense=1,
                                      d_ff_shared=64)),
    "granite_moe_3b_a800m": dict(
        num_layers=2, d_model=256, num_heads=4, kv_heads=2, d_ff=64,
        vocab_size=256, moe=MoEConfig(num_experts=4, top_k=2,
                                      d_ff_expert=64)),
    "internvl2_2b": dict(num_layers=2, d_model=256, num_heads=2,
                         kv_heads=1, d_ff=256, vocab_size=256,
                         vlm=VLMConfig(num_patches=8, d_patch=32)),
}


@pytest.mark.parametrize("arch", list(KERNEL_SHAPED))
def test_kernel_branch_passes_the_launch_checks(arch, monkeypatch):
    """On the card the kernel branch must hand each kernel what its launch
    takes (contiguous, dtype, shape). Here every launch check runs on the
    CPU tensors up to the library call, which a stub stops; the plain
    version then answers. One launch per layer, as on the card."""
    launch_checked_logits(get_config(arch).replace(
        attn_impl="kernel", **KERNEL_SHAPED[arch]), monkeypatch)


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "mamba2_1_3b",
                                  "phi3_mini_3_8b", "qwen3_14b",
                                  "deepseek_coder_33b", "kimi_k2_1t_a32b",
                                  "granite_moe_3b_a800m", "internvl2_2b"])
def test_smoke_kernel_branch_passes_the_launch_checks(arch, monkeypatch):
    """The smoke configs as they are (head dims 8 and 16, Mamba2's chunk
    32, P 16, N 16) pass every launch check too, as ``chip_smoke.py``'s
    ``lm_smoke_kernels`` runs them on the card."""
    launch_checked_logits(get_smoke(arch).replace(attn_impl="kernel"),
                          monkeypatch, seq=96)


def launch_checked_logits(cfg, monkeypatch, seq=130):
    """``cfg``'s kernel-branch logits with every kernel launch checked up
    to the library call, then answered by the plain version."""
    monkeypatch.setattr(build, "library", _stop)
    seen = []

    def through(launch, plain, name):
        def run(*args, **kw):
            with pytest.raises(_Stop):
                launch(*args, **kw)
            seen.append(name)
            return plain(*args, **kw)
        return run

    monkeypatch.setattr(fa, "flash_attention_gqa", through(
        lambda q, k, v, causal=True: fa._launch(q, k, v, causal),
        fa.flash_attention_gqa_plain, "flash_attention"))
    monkeypatch.setattr(ssd, "ssd_scan", through(
        lambda x, dt, a, b, c, chunk=128: ssd._launch(x, dt, a, b, c,
                                                      chunk),
        ssd.ssd_scan_plain, "ssd_scan"))
    model = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    batch = {"tokens": torch.as_tensor(tokens(2, seq)).long()}
    if cfg.vlm is not None:
        batch["patches"] = torch.randn((2, cfg.vlm.num_patches,
                                        cfg.vlm.d_patch),
                                       generator=torch.Generator()
                                       .manual_seed(1))
    with torch.inference_mode():
        out = model.logits(batch)
    assert torch.isfinite(out).all()
    assert out.shape == (2, seq, cfg.padded_vocab)
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    assert seen == [kernel] * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """Teacher forcing, as tests/test_models.py does: prefill 4 tokens
    then decode one at a time; each step's logits equal the full
    forward's at that position, and the reference's own step logits."""
    jm, params, model = pair(arch, "float32")
    b, s = 2, 8
    tok = tokens(b, s, seed=3)
    with torch.inference_mode():
        full = model.logits({"tokens": torch.as_tensor(tok).long()})
        cache = model.init_cache(b, 32)
        jcache = jm.init_cache(b, 32)
        lp, cache = model.prefill(cache, {"tokens": torch.as_tensor(
            tok[:, :4]).long()})
        jlp, jcache = jm.prefill(params, jcache,
                                 {"tokens": jnp.asarray(tok[:, :4])})
        close(lp[:, 0], full[:, 3], 1e-4)
        close(lp, jlp, 1e-4)
        for t in range(4, s):
            ld, cache = model.decode_step(
                cache, {"tokens": torch.as_tensor(tok[:, t:t + 1]).long()})
            jld, jcache = jm.decode_step(
                params, jcache, {"tokens": jnp.asarray(tok[:, t:t + 1])})
            close(ld[:, 0], full[:, t], 1e-4)
            close(ld, jld, 1e-4)
    assert cache["index"] == int(jcache["index"]) == s


def test_cache_clamps_past_max_seq():
    """Writing past ``max_seq``: the reference's dynamic_update_slice
    clamps the start so the update fits, positions run on unclamped; the
    port does the same, step for step."""
    jm, params, model = pair("tinyllama_1_1b", "float32")
    tok = tokens(2, 12, seed=4)
    with torch.inference_mode():
        cache, jcache = model.init_cache(2, 6), jm.init_cache(2, 6)
        steps = [(0, 4)] + [(t, t + 1) for t in range(4, 9)]
        for a, b in steps:
            got, cache = model.forward_cached(
                cache, {"tokens": torch.as_tensor(tok[:, a:b]).long()})
            want, jcache = jm.forward_cached(
                params, jcache, {"tokens": jnp.asarray(tok[:, a:b])})
            close(got, want, 1e-4)
        close(cache["dense"]["k"], jcache["dense"]["k"], 1e-5)
        close(cache["dense"]["v"], jcache["dense"]["v"], 1e-5)
    assert cache["index"] == int(jcache["index"]) == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_equal_reference(arch):
    """Greedy tokens of the slot engine, equal to the reference's on the
    float32 smoke config: 5 prompts of 3-11 tokens (left-padded, pad
    tokens attended) in batches of 2, the last batch short."""
    jm, params, model = pair(arch, "float32")
    from repro_torch.launch.serve import make_prompts
    prompts = make_prompts(model.cfg.vocab_size, 5)
    want = RefServeEngine(jm, params, batch_size=2, max_seq=32).generate(
        prompts, max_new_tokens=6)
    got = ServeEngine(model, batch_size=2, max_seq=32).generate(
        prompts, max_new_tokens=6)
    assert got == want
    assert all(len(o) >= 1 for o in got)


def test_serve_engine_argmax_spans_padded_vocab():
    """vocab 200 pads to 256 rows; greedy decoding takes its argmax over
    all 256, as the reference's does, so tokens >= 200 can come out."""
    jcfg = ref_get_smoke("tinyllama_1_1b").replace(
        vocab_size=200, param_dtype="float32", activation_dtype="float32")
    jm = ref_build_model(jcfg)
    params = jm.init_params(jax.random.PRNGKey(5))
    cfg = interop.lm_config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.padded_vocab == 256
    model = build_model(cfg, "cpu")
    model.load_state_dict(interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    from repro_torch.launch.serve import make_prompts
    prompts = make_prompts(cfg.vocab_size, 4, seed=1)
    want = RefServeEngine(jm, params, batch_size=4, max_seq=32).generate(
        prompts, max_new_tokens=12)
    got = ServeEngine(model, batch_size=4, max_seq=32).generate(
        prompts, max_new_tokens=12)
    assert got == want
    assert max(max(o) for o in got) >= cfg.vocab_size


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2-1.3b", "--smoke", "--requests", "3",
                "--max-new", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests" in out and "tok/s on cpu" in out


def test_init_params_is_seeded():
    """Random weights from a torch.Generator seed: same seed, same
    weights; the reference's scales (embed N(0, 1), a_log -0.5)."""
    cfg = get_smoke("mamba2-1.3b")
    m1 = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(3))
    m2 = build_model(cfg, "cpu").init_params(
        torch.Generator().manual_seed(3))
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    assert abs(float(m1.embed.float().std()) - 1.0) < 0.05
    assert torch.equal(m1.layers[0].mixer.a_log,
                       torch.full_like(m1.layers[0].mixer.a_log, -0.5))
    mixer = L.init_mamba2(cfg, torch.Generator().manual_seed(3), "cpu")
    assert torch.equal(mixer.d_skip, torch.ones_like(mixer.d_skip))
    assert mixer.w_in.dtype == torch.bfloat16


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_match_reference(arch, which):
    """Field by field, the reference's ``attn_impl`` name mapped."""
    ref = ref_get_config(arch) if which == "full" else ref_get_smoke(arch)
    mine = get_config(arch) if which == "full" else get_smoke(arch)
    theirs = dataclasses.asdict(ref)
    ours = dataclasses.asdict(mine)
    assert ours.pop("attn_impl") == IMPLS[theirs.pop("attn_impl")]
    assert ours == theirs
    assert mine.padded_vocab == ref.padded_vocab
    assert mine == interop.lm_config_from_fields(dataclasses.asdict(ref))


def test_full_config_sizes():
    tl = get_config("tinyllama-1.1b")
    assert (tl.num_layers, tl.d_model, tl.num_heads, tl.kv_heads, tl.hd,
            tl.d_ff, tl.padded_vocab) == (22, 2048, 32, 4, 64, 5632, 32000)
    mb = get_config("mamba2-1.3b")
    assert L.ssm_dims(mb) == (4096, 64, 64, 128)
    assert (mb.num_layers, mb.padded_vocab) == (48, 50432)
    model = build_model(tl, "meta")
    n = sum(p.numel() for p in model.state_dict().values())
    assert 1.09e9 < n < 1.11e9


def test_params_from_numpy_rejects_missing_and_extra_keys():
    jm, params, model = pair("tinyllama_1_1b")
    tree = jax.tree.map(np.asarray, params)
    cfg = model.cfg
    missing = dict(tree)
    del missing["ln_f"]
    with pytest.raises(ValueError, match="missing.*ln_f.scale"):
        interop.lm_params_from_numpy(cfg, missing)
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra.*bias"):
        interop.lm_params_from_numpy(cfg, extra)
    short = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        interop.lm_params_from_numpy(cfg, short)


def test_params_from_numpy_is_exact_in_bf16():
    """bf16 goes through float32, so every weight arrives bit-exact, and
    every stacked layer lands at its own index."""
    jm, params, model = pair("mamba2_1_3b")
    tree = jax.tree.map(np.asarray, params)
    state = model.state_dict()
    for i in range(model.cfg.num_layers):
        want = np.asarray(tree["layers"]["mixer"]["w_in"][i], np.float32)
        got = state[f"layers.{i}.mixer.w_in"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
