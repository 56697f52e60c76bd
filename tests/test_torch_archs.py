"""Every model of the port's registry against the JAX reference: the
counterpart of tests/test_archs.py over the registry's 11 ids.

Same weights (the reference's init at the reduced size, converted with
`repro_torch.convert`), same numpy inputs; llava is fed stub embeds in
place of tokens, whisper stub frame embeds (24 frames) for its encoder and
tokens for its decoder. Tolerances, each where it is used:
  - configs: every field equal to the reference's (`dataclasses.asdict`);
  - the train-mode forward and `lm_loss` against the reference run EAGERLY
    (`jax.disable_jit`: under `jax.jit` XLA turns a division by a constant
    into a multiplication by its reciprocal, and an ulp moved before a 4/6
    absmax moves whole codes), the bars of tests/test_torch_train.py: bf16
    loss within 1e-3 relative; quartet2 logits within Q2_NOISE_FRACTION of
    the reference's own quantization error (its quartet2 logits against its
    bf16 logits, relative RMS), and the quartet2 loss within the
    reference's own quartet2-bf16 loss shift and within Q2_LOSS_RTOL = 1e-5
    relative (measured: the quartet2 losses equal, or one f32 ulp apart;
    rwkv6 and recurrentgemma 1.5e-7; whisper's logits and loss bitwise);
  - prefill + 3 decode steps against one train-mode forward over the same
    tokens: within FULL_FORWARD_FRACTION (5%) of max|logit|, the reference's
    bar (tests/test_archs.py). MoE configs use capacity_factor 8.0 (nothing
    drops, so prefill and the full forward route alike); llava checks its
    prefill from embeds only, as the reference skips its decode; whisper
    encodes its frames, prefills 16 decoder tokens into
    `lm.init_encdec_cache` and decodes 3 over the cached encoder output;
The recurrent families (rwkv6, recurrentgemma) run every check above, and
their stage structure and parameter tree equal the reference's; whisper's
modules, tree, gradients and training are in tests/test_torch_whisper.py,
and it stays out of the engine files (the reference's engine refuses
enc-dec). The serving
steps of the new configs are in tests/test_torch_archs_serve.py (another
file, so the eager-JAX halves run on two workers); the recurrent families'
modules, serving and training in tests/test_torch_{rwkv,griffin,
recurrent_serve,recurrent_train}.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import lm

ARCHS = registry.names()
SEED = np.array([1, 2], np.uint32)
Q2_NOISE_FRACTION = 0.75
Q2_LOSS_RTOL = 1e-5
FULL_FORWARD_FRACTION = 0.05


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_registry_is_the_references_transformers():
    assert registry.names() == jregistry.names()
    assert len(registry.names()) == 11


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch):
    cfg = registry.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jregistry.get(arch))
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jregistry.get(arch).reduced())
    n = sum(len(pat) * count for pat, count in lm.layer_specs(cfg))
    assert n == cfg.n_layers


def _capacity8(cfg):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


@functools.lru_cache(maxsize=None)
def _weights(arch, capacity8=False):
    jcfg, cfg = jregistry.get(arch).reduced(), registry.get(arch).reduced()
    if capacity8 and cfg.moe:
        jcfg, cfg = _capacity8(jcfg), _capacity8(cfg)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


ENC_FRAMES = 24  # whisper's stub frames a row (its decoder reads 16 tokens)


def _batch(cfg, b=2, s=16, seed=0):
    """(reference batch, port batch) of the same values: tokens or stub
    embeds (bf16 normals x 0.3) and labels; whisper both (ENC_FRAMES
    frames for the encoder, s tokens for the decoder)."""
    rs = np.random.RandomState(seed)
    j = {"labels": rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeds":
        frames = ENC_FRAMES if cfg.enc_dec else s
        emb = jnp.asarray(rs.randn(b, frames, cfg.d_model) * 0.3, jnp.bfloat16)
        j["embeds"] = emb
    if cfg.input_mode == "tokens" or cfg.enc_dec:
        j["tokens"] = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    t = {k: (torch.from_numpy(np.asarray(v, np.float32)).bfloat16()
             if k == "embeds" else torch.from_numpy(v)) for k, v in j.items()}
    return j, t


def _rel_rms(x, y):
    return float(np.sqrt(((x - y) ** 2).mean() / (y ** 2).mean()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_and_loss_match_eager_jax(arch):
    jcfg, cfg, jparams, params = _weights(arch)
    jb, tb = _batch(cfg)
    jseed = jnp.asarray(SEED)
    out = {}
    for scheme in ("bf16", "quartet2"):
        with jax.disable_jit():  # one eager pass: lm_loss's own arithmetic
            hidden, _, aux = jlm.forward(jparams, jcfg, jb, scheme, jseed,
                                         mode="train", head=False)
            hw = jlm.head_weight(jparams, jcfg)
            jlogits = np.asarray(jblocks.lm_head(
                hidden, hw, jcfg.quantize_lm_head, scheme,
                jseed).astype(jnp.float32))
            jloss = float(jblocks.chunked_head_ce(
                hidden, hw, jb["labels"], jcfg.quantize_lm_head, scheme,
                jseed) + 0.01 * aux)
        with torch.no_grad():
            logits = lm.forward(params, cfg, tb, scheme, SEED,
                                mode="train")[0].float().numpy()
            loss = float(lm.lm_loss(params, cfg, tb, scheme, SEED))
        assert logits.shape == jlogits.shape == (2, 16, cfg.vocab)
        assert np.isfinite(logits).all() and np.isfinite(loss)
        out[scheme] = (jlogits, logits, jloss, loss)
    jl, _, jloss, loss = out["bf16"]
    assert loss == pytest.approx(jloss, rel=1e-3)
    jq, tq, jqloss, qloss = out["quartet2"]
    assert _rel_rms(tq, jq) <= Q2_NOISE_FRACTION * _rel_rms(jq, jl)
    assert abs(qloss - jqloss) <= abs(jqloss - jloss)
    assert qloss == pytest.approx(jqloss, rel=Q2_LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_a_full_forward(arch):
    """Prefill 16 positions into dense caches, decode 3 tokens, against one
    train-mode forward over all 19."""
    _, cfg, _, params = _weights(arch, capacity8=True)
    b, s, extra = 2, 16, 3
    rs = np.random.RandomState(3)
    if cfg.enc_dec:
        _encdec_prefill_then_decode(cfg, params, b, s, extra, rs)
        return
    if cfg.input_mode == "embeds":
        emb = torch.from_numpy(
            rs.randn(b, s, cfg.d_model).astype(np.float32) * 0.3).bfloat16()
        full_in, pf_in = {"embeds": emb}, {"embeds": emb}
    else:
        toks = torch.from_numpy(rs.randint(0, cfg.vocab, (b, s + extra)))
        full_in, pf_in = {"tokens": toks}, {"tokens": toks[:, :s]}
    with torch.no_grad():
        full = lm.forward(params, cfg, full_in, "bf16", SEED,
                          mode="train")[0].float()
        tol = FULL_FORWARD_FRACTION * float(full.abs().max())
        cache = lm.init_cache(cfg, b, s + 8, device="cpu")
        pf, cache = lm.forward(params, cfg, pf_in, "bf16", SEED, caches=cache,
                               mode="prefill")
        assert float((pf.float() - full[:, :s]).abs().max()) < tol
        if cfg.input_mode == "embeds":
            return  # the reference generates vlm decode from tokens only
        for step in range(extra):
            dl, cache = lm.forward(
                params, cfg, {"tokens": toks[:, s + step: s + step + 1]},
                "bf16", SEED, caches=cache, mode="decode", pos=s + step)
            err = float((dl[:, 0].float() - full[:, s + step]).abs().max())
            assert err < tol, (arch, step, err)


def _encdec_prefill_then_decode(cfg, params, b, s, extra, rs):
    """Whisper: ENC_FRAMES frames encoded and s tokens prefilled into
    `init_encdec_cache`, then `extra` decode steps over the cached encoder
    output, each against one train-mode forward over all s + extra tokens."""
    emb = torch.from_numpy(rs.randn(b, ENC_FRAMES, cfg.d_model).astype(
        np.float32) * 0.3).bfloat16()
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, (b, s + extra)))
    with torch.no_grad():
        full = lm.forward(params, cfg, {"embeds": emb, "tokens": toks}, "bf16",
                          SEED, mode="train")[0].float()
        tol = FULL_FORWARD_FRACTION * float(full.abs().max())
        cache = lm.init_encdec_cache(cfg, b, s + 8, ENC_FRAMES, device="cpu")
        pf, cache = lm.forward(params, cfg, {"embeds": emb,
                                             "tokens": toks[:, :s]},
                               "bf16", SEED, caches=cache, mode="prefill")
        assert float((pf.float() - full[:, :s]).abs().max()) < tol
        assert float(cache["enc_out"].float().abs().max()) > 0
        for step in range(extra):
            dl, cache = lm.forward(
                params, cfg, {"tokens": toks[:, s + step: s + step + 1]},
                "bf16", SEED, caches=cache, mode="decode", pos=s + step)
            err = float((dl[:, 0].float() - full[:, s + step]).abs().max())
            assert err < tol, (step, err)


@pytest.mark.parametrize("arch", ["rwkv6_7b", "recurrentgemma_9b"])
def test_recurrent_layer_specs_and_tree_equal_the_reference(arch):
    """The recurrent families' stage structure (rwkv6: 32 x (rwkv_tm,
    rwkv_cm); recurrentgemma: 12 x (rec, rec, lattn) + (rec, rec)) and the
    parameter tree `lm.init` draws: the reference's paths and shapes."""
    jcfg, cfg = jregistry.get(arch), registry.get(arch)
    assert lm.layer_specs(cfg) == jlm.layer_specs(jcfg)
    assert lm.total_layers(cfg) == cfg.n_layers
    jr, r = jcfg.reduced(), cfg.reduced()
    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(v.shape) for path, v in jax.tree_util.tree_flatten_with_path(
                jax.eval_shape(lambda: jlm.init(jr, jax.random.PRNGKey(0))))[0]}
    got = {}

    def walk(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            got[path] = tuple(tree.shape)

    walk(lm.init(r, torch.Generator().manual_seed(0), "cpu"))
    assert got == want
