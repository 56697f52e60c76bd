"""Whisper's encoder-decoder path in the port against the JAX reference:
`blocks.layernorm`, the gelu MLP, the enc-dec parameter tree and
`convert`, the encode mode, prefill + decode, gradients and training.

Reduced whisper-tiny (2 + 2 layers, d 128, 4 heads over 2 KV heads, vocab
512; the reference's init, converted with `repro_torch.convert`), 2 rows of
24 stub frames and 16 decoder tokens, the same numpy inputs to both
packages. Tolerances, each where it is used:
  - `layernorm` against the reference run EAGERLY, its two-pass variance
    written out: on bf16 inputs (the model's) each output within 1 bf16
    ulp of its own magnitude, on f32 inputs within LN_F32_ULPS f32 ulps of
    the row's largest |output|. The cause is the f32 summation order of the
    row's mean and variance (XLA's reduction against PyTorch's: a mean one
    ulp apart in 34 of 64 rows of 384), which the cancelling x - mean
    turns into large relative errors near zero, so the bars scale with the
    row, not the element;
  - the gelu activation: XLA's CPU `tanh` is a polynomial up to 4 f32 ulps
    from `torch.tanh`, so the f32 activation lies within |x| * 2^-22 of
    `jax.nn.gelu` (0.5 |x| times 4 ulps of tanh near 1, doubled), and with
    XLA's tanh values substituted the port's formula is bitwise; the gelu
    MLP under quartet2 is bitwise eager JAX (no activation code moves);
  - the train-mode forward and `lm_loss` are tests/test_torch_archs.py's
    whisper case (quartet2 bitwise eager JAX, bf16 loss within 1e-3);
  - prefill + 3 decode steps against the reference's own prefill and
    decode logits under bf16 (jitted): within DECODE_ULPS bf16 ulps of the
    largest |logit| (f32 summation order of the bf16 GEMMs and XLA's
    tanh), and the port's decode logits bitwise its own train-mode forward
    over the same tokens;
  - bf16 gradients against the reference's jitted `jax.value_and_grad`:
    the loss within 1e-3 relative and every leaf within GRAD_REL_RMS =
    5e-2 relative RMS, the recurrent training tests' bar against jitted JAX
    (measured 1.7e-2 at most, the cross-attention's norm gain; eager JAX
    1.3e-2: bf16 ties that fall the other way compound over the encoder and
    the decoder), the unused `head` exactly zero in both;
  - one `make_train_step` step under bf16 against the reference's jitted
    step: the loss and the gradient norm within 1e-3 relative;
  - `launch/train.py --arch whisper_tiny --reduced --device cpu`, 2 steps,
    finite losses; serving refuses enc-dec as the reference does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.train import train_step as jts
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import blocks, lm
from repro_torch.optim import adamw
from repro_torch.serve.decode import greedy_generate
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.train import train_step as ts

ARCH = "whisper_tiny"
SEED = np.array([5, 6], np.uint32)
B, FRAMES, S = 2, 24, 16
DECODE_ULPS = 2
GRAD_REL_RMS = 5e-2
LN_F32_ULPS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, cfg = jregistry.get(ARCH).reduced(), registry.get(ARCH).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _batch(cfg, seed=0):
    """(reference batch, port batch): FRAMES stub frames (bf16 normals x
    0.3), S decoder tokens and labels a row."""
    rs = np.random.RandomState(seed)
    emb = np.asarray(jnp.asarray(rs.randn(B, FRAMES, cfg.d_model) * 0.3,
                                 jnp.bfloat16).astype(jnp.float32))
    toks = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
    j = {"embeds": jnp.asarray(emb, jnp.bfloat16), "tokens": toks,
         "labels": labels}
    t = {"embeds": torch.from_numpy(emb).bfloat16(),
         "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    return j, t


def _bf16_ulps(x, y):
    """|x - y| in bf16 ulps of the larger magnitude, elementwise."""
    m = np.maximum(np.maximum(np.abs(x), np.abs(y)), 2.0 ** -126)
    return np.abs(x - y) / 2.0 ** (np.floor(np.log2(m)) - 7)


def _rel_rms(x, y):
    return float(np.sqrt(((x - y) ** 2).mean() / max((y ** 2).mean(), 1e-30)))


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_layernorm_matches_eager_jax(dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(64, 384) * 3 + 0.5).astype(np.float32)
    g, b = rs.randn(384).astype(np.float32), rs.randn(384).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    with jax.disable_jit():
        want = np.asarray(jblocks.layernorm(jx, jnp.asarray(g), jnp.asarray(b))
                          .astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = blocks.norm(tx, {"g": torch.from_numpy(g), "b": torch.from_numpy(b)},
                      "layernorm", 1e-5)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "bfloat16":
        assert _bf16_ulps(got, want).max() <= 1
    else:
        row = np.abs(want).max(axis=-1, keepdims=True)
        ulp = 2.0 ** (np.floor(np.log2(row)) - 23)
        assert (np.abs(got - want) <= LN_F32_ULPS * ulp).all()
    p = blocks.norm_init(384, "layernorm", "cpu")
    assert sorted(p) == ["b", "g"] and float(p["g"].sum()) == 384
    assert float(p["b"].abs().sum()) == 0


def test_gelu_within_tanh_error_of_jax_and_bitwise_with_its_tanh():
    rs = np.random.RandomState(2)
    x = (rs.randn(64, 1536) * 3).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = blocks.gelu_tanh(torch.from_numpy(x)).numpy()
    assert (np.abs(got - want) <= np.abs(x) * 2.0 ** -22).all()
    xt = torch.from_numpy(x)
    inner = blocks.SQRT_2_OVER_PI * (xt + 0.044715 * (xt * xt * xt))
    xla_tanh = torch.from_numpy(np.asarray(jnp.tanh(jnp.asarray(inner.numpy()))))
    np.testing.assert_array_equal((xt * (0.5 * (1.0 + xla_tanh))).numpy(), want)


def test_gelu_mlp_quartet2_bitwise_eager_jax():
    jcfg, cfg, jparams, params = _weights()
    x = np.random.RandomState(3).randn(B, S, cfg.d_model).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jp = jax.tree.map(lambda a: a[1], jparams["stages"][0]["l0"]["ff"])
    with jax.disable_jit():
        want = np.asarray(jblocks.mlp_apply(jp, jx, "gelu", "quartet2",
                                            jnp.asarray(SEED), 1)
                          .astype(jnp.float32))
    tp = lm.layer_params(params["stages"][0]["l0"]["ff"], 1)
    got = blocks.mlp_apply(tp, torch.from_numpy(np.asarray(
        jx.astype(jnp.float32))).bfloat16(), "gelu", "quartet2", SEED, 1)
    np.testing.assert_array_equal(got.float().numpy(), want)


# --------------------------------------------------------------------------
# the tree, convert, the encode mode
# --------------------------------------------------------------------------

def test_encdec_tree_equals_the_reference_and_converts():
    """`lm.init` draws the reference's paths and shapes (no `embed`, an
    unused `head`, the decoder under `dec_*` with `xattn` and `nx` a
    layer, layernorm gains and biases), and `convert` carries every leaf."""
    jcfg, cfg, jparams, params = _weights()
    assert lm.layer_specs(cfg) == jlm.layer_specs(jcfg)
    assert lm.DEC_STAGES(cfg) == jlm.DEC_STAGES(jcfg)

    def walk(tree, path=(), out=None):
        out = {} if out is None else out
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,), out)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,), out)
        else:
            out[path] = tree
        return out

    want = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
            np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    drawn = walk(lm.init(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert {k: tuple(v.shape) for k, v in drawn.items()} == \
        {k: v.shape for k, v in want.items()}
    assert ("embed",) not in drawn and ("head",) in drawn
    assert ("dec_stages", 0, "l0", "xattn", "wk") in drawn
    assert ("stages", 0, "l0", "n1", "b") in drawn
    got = walk(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=str(k))
    assert lm.head_weight(params, cfg) is params["dec_head"]


def test_encoder_is_bidirectional_and_decoder_causal():
    """Moving the last frame moves the first decoder position's logits
    (through the unmasked encoder and cross-attention); moving the last
    token does not (the decoder's mask)."""
    _, cfg, _, params = _weights()
    _, tb = _batch(cfg)
    with torch.no_grad():
        base = lm.forward(params, cfg, tb, "bf16", SEED, mode="train")[0]
        frames = tb["embeds"].clone()
        frames[:, -1] += 1.0
        moved = lm.forward(params, cfg, {**tb, "embeds": frames}, "bf16",
                           SEED, mode="train")[0]
        toks = tb["tokens"].clone()
        toks[:, -1] = (toks[:, -1] + 1) % cfg.vocab
        late = lm.forward(params, cfg, {**tb, "tokens": toks}, "bf16", SEED,
                          mode="train")[0]
    assert not torch.equal(moved[:, 0], base[:, 0])
    assert torch.equal(late[:, :-1], base[:, :-1])


# --------------------------------------------------------------------------
# prefill + decode
# --------------------------------------------------------------------------

def test_prefill_and_decode_match_the_reference_decode_logits():
    jcfg, cfg, jparams, params = _weights()
    jb, tb = _batch(cfg)
    pre, extra = S - 3, 3
    jseed = jnp.asarray(SEED)
    jcache = jlm.init_encdec_cache(jcfg, B, S + 8, FRAMES)
    fwd = jax.jit(lambda p, inp, c, pos, mode: jlm.forward(
        p, jcfg, inp, "bf16", jseed, caches=c, mode=mode, pos=pos)[:2],
        static_argnames="mode")
    jl, jcache = fwd(jparams, {"embeds": jb["embeds"],
                               "tokens": jb["tokens"][:, :pre]}, jcache, None,
                     mode="prefill")
    want = [np.asarray(jl.astype(jnp.float32))]
    for t in range(pre, S):
        jl, jcache = fwd(jparams, {"tokens": jb["tokens"][:, t:t + 1]}, jcache,
                         t, mode="decode")
        want.append(np.asarray(jl.astype(jnp.float32)))
    cache = lm.init_encdec_cache(cfg, B, S + 8, FRAMES, device="cpu")
    with torch.no_grad():
        full = lm.forward(params, cfg, tb, "bf16", SEED, mode="train")[0]
        logits, cache = lm.forward(params, cfg, {"embeds": tb["embeds"],
                                                 "tokens": tb["tokens"][:, :pre]},
                                   "bf16", SEED, caches=cache, mode="prefill")
        got = [logits.float().numpy()]
        for t in range(pre, S):
            logits, cache = lm.forward(params, cfg,
                                       {"tokens": tb["tokens"][:, t:t + 1]},
                                       "bf16", SEED, caches=cache,
                                       mode="decode", pos=t)
            got.append(logits.float().numpy())
            assert torch.equal(logits[:, 0], full[:, t])
    assert len(got) == extra + 1
    for g, w in zip(got, want):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(g - w).max() <= DECODE_ULPS * ulp


# --------------------------------------------------------------------------
# gradients and training
# --------------------------------------------------------------------------

def _fresh(params):
    if isinstance(params, dict):
        return {k: _fresh(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_fresh(v) for v in params]
    return params.detach().clone().requires_grad_(True)


def test_bf16_loss_and_every_gradient_match_jax():
    jcfg, cfg, jparams, params = _weights()
    jb, tb = _batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(
        p, jcfg, jb, "bf16", jnp.asarray(SEED))))(jparams)
    named = [(jax.tree_util.keystr(k), np.asarray(v, np.float32))
             for k, v in jax.tree_util.tree_leaves_with_path(jgrads)]
    params = _fresh(params)
    leaves = adamw.leaves(params)
    loss = lm.lm_loss(params, cfg, tb, "bf16", SEED)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-3)
    assert len(grads) == len(named)
    for (path, jg), g in zip(named, grads):
        if path == "['head']":  # drawn, never read: zero in both
            assert g is None and not jg.any()
            continue
        g = g.float().numpy()
        assert g.shape == jg.shape and np.isfinite(g).all(), path
        assert _rel_rms(g, jg) <= GRAD_REL_RMS, (path, _rel_rms(g, jg))


def test_one_train_step_matches_the_reference_step():
    jcfg, cfg, jparams, params = _weights()
    jb, tb = _batch(cfg)
    kw = dict(base_lr=2e-3, total_steps=2)
    jinit, jstep = jts.make_train_step(jcfg, "bf16", **kw)
    _, jm = jax.jit(jstep)(jinit(jparams), jb)
    init, step = ts.make_train_step(cfg, "bf16", **kw)
    state, m = step(init(_fresh(params)), tb)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-3)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-3)
    assert state.step == 1
    assert all(bool(torch.isfinite(p).all()) for p in adamw.leaves(state.params))


def test_launch_train_whisper_on_cpu():
    out, _, state = launch_train.run([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--seq", "16", "--batch", "2", "--log-every", "1"])
    assert out["arch"] == "whisper-tiny-smoke" and out["steps"] == 2
    assert all(np.isfinite(x) for x in out["losses"])
    assert "dec_head" in state.params and "embed" not in state.params


def test_serving_refuses_encdec_as_the_reference():
    _, cfg, _, params = _weights()
    with pytest.raises(NotImplementedError, match="enc-dec serving"):
        ServeEngine(cfg, params, EngineConfig(device="cpu"))
    with pytest.raises(NotImplementedError, match="enc-dec path"):
        greedy_generate(params, cfg, "bf16", np.zeros((1, 4), np.int32), 2,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="draft"):
        lm.forward_prefix(params, cfg, {"tokens": torch.zeros((1, 1))}, "bf16",
                          SEED, n_prefix=1)
    with pytest.raises(SystemExit, match="enc-dec serving"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
