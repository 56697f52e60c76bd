"""Serving over a mesh's "model" axis in the port (`EngineConfig(mesh=
make_serve_mesh(1, 2, devices=["cpu"] * 2))` and a (2, 2) mesh on
`["cpu"] * 4`): every linear weight's out-features (the embedding's and the
head's vocab rows too) split over the model devices, each data shard's split
linears running each part on its model device and concatenating the outputs
in model order.

Held on reduced llama-200m, on one thread:
  - the streams bitwise the port's unsharded engine's under bf16 and
    quartet2, over the bf16 and the NVFP4 pool, with prequantized weights
    and raw ones (the raw 4/6 quantization of each slice taking the whole
    weight's absmax: #1's given-absmax entry), at (1, 2); at (2, 2) bf16
    against unsharded and quartet2 against (2, 1) (a data shard's absmax
    spans its own slots, so quartet2 compares to the data-sharded engine);
    speculation and the prefix cache bitwise too, and the registry's other
    dense GQA transformers at (1, 2) under quartet2;
  - each device's split fields byte for byte the slices of the whole
    packed tree's fields, the device holding half the split bytes;
  - the port's serving specs leaf for leaf the reference's
    `serve_param_shardings` on a (1, 2) jax mesh over the 2 host devices
    tests/conftest.py provides;
  - the model-2 engine against the reference's unsharded jitted engine up
    to bf16 near-ties (`tests/_torch_streams.py`);
  - the refusals over "model": MLA, MoE, the recurrent families, dense
    caches and the disaggregated roles;
  - the vocab-split embedding's sum exact to the sign of zero; the new
    kernel's plain version against `_mm`, and its wrapper reached by every
    GEMM outside an autograd graph and by none inside one; #1 with a given
    absmax against the whole tensor's quantization; `launch.serve
    --model-shards`.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import registry as jregistry
from repro.dist import sharding as jsharding
from repro.models import lm as jlm
from repro.serve import prequant as jprequant
from repro_torch.configs import registry
from repro_torch.core import linear as L
from repro_torch.core.linear import ModelShard, PackedQWeight
from repro_torch.dist import sharding as S
from repro_torch.kernels import bf16_matmul as BM
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import blocks
from repro_torch.models import lm
from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
from repro_torch.serve.prequant import prequantize
from tests._torch_streams import (assert_equal_up_to_bf16_ties, run_jax,
                                  run_port)

CFG = registry.get("llama_200m").reduced()
PROMPT_LENS = (9, 13, 7, 11)
MAX_NEW = 5
M12 = make_serve_mesh(1, 2, devices=["cpu"] * 2)
M21 = make_serve_mesh(2, 1, devices=["cpu"] * 2)
M22 = make_serve_mesh(2, 2, devices=["cpu"] * 4)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _params():
    return lm.init(CFG, torch.Generator().manual_seed(0), "cpu")


PARAMS = _params()


def _prompts(lens=PROMPT_LENS, seed=1):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, CFG.vocab, n))) for n in lens]


def _engine(cfg=CFG, params=None, **kw):
    for k, v in dict(n_slots=4, max_len=32, prefill_chunk=8, scheme="bf16",
                     device="cpu").items():
        kw.setdefault(k, v)
    return ServeEngine(cfg, PARAMS if params is None else params,
                       EngineConfig(**kw))


def _streams(eng, prompts, max_new=MAX_NEW):
    ids = [eng.submit(Request(p, max_new)) for p in prompts]
    res = {r.req_id: r.tokens for r in eng.run()}
    assert eng.pool.free_block_count + (
        eng.cache.cached_blocks() if eng.cache is not None else 0) \
        == eng.pool.n_blocks
    return [res[i] for i in ids]


# --------------------------------------------------------------------------
# streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prequant", [True, False], ids=["prequant", "raw"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16pool", "nvfp4pool"])
@pytest.mark.parametrize("scheme", ["bf16", "quartet2"])
def test_model_streams_bitwise_unsharded(scheme, kv_quant, prequant):
    """(1, 2): the streams are the unsharded engine's, bit for bit."""
    kw = dict(scheme=scheme, kv_quant=kv_quant, prequant=prequant)
    # raw quartet2 weights quantize every step on the CPU: a shorter run
    prompts, new = ((_prompts(), MAX_NEW) if prequant or scheme == "bf16"
                    else (_prompts()[:2], 3))
    want = _streams(_engine(**kw), prompts, new)
    eng = _engine(mesh=M12, **kw)
    assert eng.params is None and len(eng.shard_params) == 1
    assert len(eng.shard_params[0]["embed"].parts) == 2
    assert _streams(eng, prompts, new) == want


@pytest.mark.parametrize("arch", ["yi_9b", "granite_8b", "chatglm3_6b",
                                  "nemotron_4_15b", "llava_next_mistral_7b"])
def test_registry_gqa_streams_bitwise_over_model(arch):
    """The registry's other dense GQA transformers (reduced: 4 heads, 2 or
    fewer KV heads; chatglm3's half-dim rope, nemotron's relu2 without a
    gate, llava's token path) at (1, 2) under quartet2 with prequant: the
    streams are the unsharded engine's, bit for bit."""
    cfg = registry.get(arch).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts((9, 13), seed=5)
    kw = dict(cfg=cfg, params=params, scheme="quartet2")
    assert _streams(_engine(mesh=M12, **kw), prompts, 3) == \
        _streams(_engine(**kw), prompts, 3)


def test_model_data_mesh_streams_bitwise():
    """(2, 2) on 4 CPU devices: bf16 bitwise the unsharded engine; quartet2
    bitwise the (2, 1) engine (each data shard quantizes its own slots'
    activations, the reference's contract)."""
    prompts = _prompts()
    assert _streams(_engine(mesh=M22), prompts) == _streams(_engine(), prompts)
    q = dict(scheme="quartet2")
    assert _streams(_engine(mesh=M22, **q), prompts, 3) == \
        _streams(_engine(mesh=M21, **q), prompts, 3)


def test_model_spec_and_prefix_cache_bitwise():
    """Speculation (spec_k 2 over 1 draft layer) and the prefix cache go
    through the same split step: the spec stream at (1, 2) is the unsharded
    spec stream; a prefix-cache hit at (1, 2) is bitwise its cold stream."""
    prompts = _prompts()
    spec = dict(spec_k=2, draft_layers=1, max_len=48)
    assert _streams(_engine(mesh=M12, **spec), prompts) == \
        _streams(_engine(**spec), prompts)
    prompt = _prompts((20,), seed=3)[0]
    eng = _engine(mesh=M12, n_slots=2, block_size=4, prefix_cache=True)
    cold = _streams(eng, [prompt])
    hot = _streams(eng, [prompt])
    assert hot == cold and eng.stats["prefill_skipped_tokens"] > 0


# --------------------------------------------------------------------------
# the split tree and its specs
# --------------------------------------------------------------------------

def _walk(tree, is_leaf):
    out = []
    S.map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


def test_split_fields_are_slices_of_the_whole_tree():
    """Every part of each ModelShard of the split tree is byte for byte its
    rank's slice of the whole prequantized tree's field (gscale the whole
    matrix's), on its own storage; unsplit leaves are the whole leaf; each
    model rank's device holds half the split bytes."""
    whole = prequantize(PARAMS, CFG, "quartet2")
    tree = S.split_serve_params(whole, M12)[0]
    is_leaf = lambda x: isinstance(x, (PackedQWeight, ModelShard))  # noqa: E731
    want = dict(_walk(whole, lambda x: isinstance(x, PackedQWeight)))
    split = 0
    for path, leaf in _walk(tree, is_leaf):
        ref = want[path]
        if not isinstance(leaf, ModelShard):
            fields = leaf if isinstance(leaf, PackedQWeight) else (leaf,)
            refs = ref if isinstance(ref, PackedQWeight) else (ref,)
            assert all(torch.equal(a, b) for a, b in zip(fields, refs)), path
            continue
        assert leaf.dim == -2 and len(leaf.parts) == 2, path
        for rank, w in enumerate(leaf.parts):
            split += 1
            if isinstance(ref, PackedQWeight):
                pairs = [(w.packed, ref.packed), (w.scale_bits, ref.scale_bits)]
                assert torch.equal(w.gscale, ref.gscale), path
            else:
                pairs = [(w, ref)]
            for got, full in pairs:
                n = full.shape[-2] // 2
                part = full.narrow(full.dim() - 2, rank * n, n)
                assert torch.equal(got, part), path
                assert got.untyped_storage().data_ptr() != \
                    full.untyped_storage().data_ptr(), path
    assert split == 2 * 9   # 7 stacked linears, the embedding, the head
    per_rank = [S.packed_bytes(tree, j) for j in range(2)]
    gscales = sum(r.gscale.numel() * 4 for _, r in want.items()
                  if isinstance(r, PackedQWeight))
    assert per_rank[0] == per_rank[1] == (S.packed_bytes(whole) + gscales) // 2


def test_specs_match_reference_serve_param_shardings():
    """The port's serving specs (prequantized quartet2 tree and raw tree)
    equal the reference's `serve_param_shardings` on a (1, 2) jax mesh,
    leaf for leaf, and `split_serve_params` splits exactly the leaves whose
    spec names "model"."""
    jcfg = jregistry.get("llama_200m").reduced()
    jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    jraw = jax.eval_shape(lambda: jlm.init(jcfg, jax.random.PRNGKey(0)))
    for scheme in ("quartet2", "bf16"):
        jtree = jax.eval_shape(lambda p: jprequant.prequantize(p, jcfg, scheme),
                               jraw)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jsharding.serve_param_shardings(jtree, jmesh))
        want = {jsharding._path_str(path): sh for path, sh in flat}
        port = prequantize(PARAMS, CFG, scheme)
        got = _walk(S.serve_param_specs(port, M12),
                    lambda x: isinstance(x, (PackedQWeight, tuple)))
        assert len(got) == len(_walk(port, lambda x: isinstance(x, PackedQWeight)))
        for path, spec in got:
            if isinstance(spec, PackedQWeight):
                for f, s in zip(("packed", "scales8", "gscale"), spec):
                    assert tuple(want[f"{path}/{f}"].spec) == s, (path, f)
            else:
                assert tuple(want[path].spec) == spec, path
        split = dict(_walk(S.split_serve_params(port, M12)[0],
                           lambda x: isinstance(x, (PackedQWeight, ModelShard))))
        for path, spec in got:
            first = spec[0] if isinstance(spec, PackedQWeight) else spec
            assert isinstance(split[path], ModelShard) == ("model" in first), path


def test_model_engine_against_reference_unsharded_engine():
    """bf16, (1, 2): the port's split engine against the reference's
    unsharded jitted engine, equal up to each row's first bf16 near-tie."""
    jcfg = jregistry.get("llama_200m").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    prompts = _prompts()
    econf = dict(n_slots=4, max_len=32, prefill_chunk=8, scheme="bf16")
    want, margins = run_jax(jcfg, jparams, prompts, MAX_NEW, **econf)
    got, _ = run_port(CFG, jparams, prompts, MAX_NEW, mesh=M12, **econf)
    assert_equal_up_to_bf16_ties(got, want, margins, len(prompts), MAX_NEW)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["mla", "moe", "rwkv", "griffin", "dense",
                                  "disagg"])
def test_model_axis_refusals(what):
    """What serving over "model" does not cover raises NotImplementedError
    naming ROADMAP.md's Queue 1 item 4.6."""
    arch = {"mla": "deepseek_v3_671b", "moe": "deepseek_moe_16b",
            "rwkv": "rwkv6_7b", "griffin": "recurrentgemma_9b"}.get(what,
                                                                 "llama_200m")
    kw = {"dense": dict(paged=False), "disagg": dict(role="prefill")}.get(what, {})
    with pytest.raises(NotImplementedError, match="4.6"):
        ServeEngine(registry.get(arch).reduced(), {},
                    EngineConfig(device="cpu", n_slots=4, mesh=M12, **kw))


def test_serve_mesh_devices():
    """make_serve_mesh names data x model devices in (data, model) order;
    too few devices raise, and so do too few cards without names."""
    assert M22.grid == ((torch.device("cpu"),) * 2,) * 2
    assert M22.devices == (torch.device("cpu"),) * 2 and M22.shape == (2, 2)
    with pytest.raises(ValueError, match="one a data shard"):
        make_serve_mesh(1, 2, devices=["cpu"])
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="CUDA devices"):
            make_serve_mesh(1, 2)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

def test_vocab_split_embedding_is_exact_to_the_sign_of_zero():
    """A table with +0.0 and -0.0 entries, looked up through two vocab
    halves summed in model order: the bits of the whole lookup."""
    g = torch.Generator().manual_seed(4)
    table = torch.randn((16, 8), generator=g)
    table[3, :4] = -0.0
    table[11, 4:] = -0.0
    table[5] = 0.0
    tokens = torch.tensor([[3, 11, 5, 0, 15, 8]])
    want = blocks.embed_lookup(table, tokens)
    got = blocks.embed_lookup(ModelShard((table[:8], table[8:]), -2), tokens)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_column_parallel_linear_is_the_slice_concatenation():
    """`qlinear` and `dense` of a split weight: the whole weight's output,
    bitwise, under bf16, quartet2 on packed slices and on raw slices (the
    given absmax), and for an in-features split (gathered whole)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn((3, 1, 64), generator=g).bfloat16()
    w = torch.randn((32, 64), generator=g) * 0.1
    for scheme, packed in (("bf16", False), ("quartet2", True),
                           ("quartet2", False)):
        whole = L.pack_weight(w, "fos") if packed else w
        want = L.qlinear(x, whole, None, scheme)
        for dim in (-2, -1):
            def part(j, t, n):
                return t.narrow(t.dim() + dim, j * n, n)
            if packed:
                if dim == -1:
                    continue   # packed weights split on N only
                split = ModelShard(tuple(
                    PackedQWeight(part(j, whole.packed, 16),
                                  part(j, whole.scale_bits, 16), whole.gscale)
                    for j in range(2)), -2)
            else:
                n = w.shape[dim] // 2
                split = ModelShard(tuple(part(j, w, n) for j in range(2)), dim)
            got = L.qlinear(x, split, None, scheme)
            assert torch.equal(got, want), (scheme, packed, dim)
    assert torch.equal(L.dense(x, ModelShard((w[:16], w[16:]), -2)),
                       L.dense(x, w))


def test_bf16_matmul_plain_matches_mm():
    """The new kernel's plain version is `_mm`'s arithmetic at every M, for
    f32 and bf16 operands (so the CPU path of a serving `_mm`, which takes
    it, is unchanged), and the wrapper routes a CPU tensor to it."""
    g = torch.Generator().manual_seed(6)
    for m in (1, 4, 64, 65, 200):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.randn((m, 72), generator=g).to(dt)
            b = torch.randn((40, 72), generator=g)
            ref = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T
            assert torch.equal(BM.bf16_matmul_plain(a, b), ref)
            assert torch.equal(L._mm(a, b), ref)
            assert torch.equal(L._mm(a, b, serving=True), ref)
            assert torch.equal(ops.bf16_matmul(a, b), ref)
    assert ops.LAUNCHES["bf16_matmul"] == 0   # plain calls are not launches


@pytest.mark.parametrize("rows", [4, 200])
def test_serving_gemms_take_the_kernel_and_training_does_not(rows,
                                                             monkeypatch):
    """`ops.bf16_matmul` (the order-fixed kernel on the card) is reached by
    every bf16 GEMM outside an autograd graph, at any row count: `qlinear`
    under bf16 and under a scheme with a bf16 forward, and `dense`; a
    training call (a weight that
    needs its gradient, grad on) and its backward keep the plain matmul."""
    calls = []
    real = ops.bf16_matmul
    monkeypatch.setattr(ops, "bf16_matmul",
                        lambda a, b: calls.append(a.shape[0]) or real(a, b))
    g = torch.Generator().manual_seed(8)
    x = torch.randn((rows, 64), generator=g).bfloat16()
    w = torch.randn((32, 64), generator=g) * 0.1
    with torch.no_grad():
        L.qlinear(x, w, None, "bf16")
        L.dense(x, w)
        L.qlinear(x, w, None, "abl_a_sr")   # a bf16 forward, SR backward
    L.qlinear(x, w, None, "bf16")            # no tensor needs a gradient
    assert calls == [rows] * 4
    wg = w.clone().requires_grad_(True)
    y = L.qlinear(x, wg, None, "bf16")
    (y.float().sum() + L.dense(x, wg).float().sum()).backward()
    assert calls == [rows] * 4 and wg.grad is not None


def test_given_absmax_quant_is_the_whole_quantization():
    """#1 with a given absmax (the plain version here): each row slice of a
    weight quantized with the whole weight's absmax is, bitwise, that slice
    of the whole weight's codes and scales, with its gscale."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn((64, 96), generator=g)
    w[40, 5] = 9.0                           # the absmax lies in one half
    whole = ops.nvfp4_fos_quant(w)
    absmax = w.abs().amax().reshape(1)
    for j in range(2):
        got = ops.nvfp4_fos_quant(w[32 * j:32 * (j + 1)].contiguous(), absmax)
        assert torch.equal(got[0], whole[0][32 * j:32 * (j + 1)])
        assert torch.equal(got[1], whole[1][32 * j:32 * (j + 1)])
        assert torch.equal(got[2], whole[2])
    own = ops.nvfp4_fos_quant(w[:32].contiguous())
    assert not torch.equal(own[2], whole[2])  # its own absmax differs


def test_launch_serve_model_shards_on_cpu(capsys):
    """`launch.serve --model-shards 2` on the CPU: 4 requests served, every
    block free, each model device's resident packed bytes half the split
    bytes (plus the replicated per-matrix gscales)."""
    out = launch_serve.main(["--device", "cpu", "--reduced", "--model-shards",
                             "2", "--batch", "4", "--prompt-len", "8",
                             "--tokens", "3"])
    assert out["requests"] == 4 and out["model_shards"] == 2
    assert out["free_blocks"] == out["n_blocks"]
    (a, b), = out["packed_bytes"]
    assert a == b and a < out["packed_bytes_whole"] * 0.51
    assert "resident packed bytes" in capsys.readouterr().out
