"""The port's data pipeline beyond the synthetic tokens: the stub embeds of
the vision family and the byte corpus, and the entry point training the two
families that need them (llava on embeds, deepseek-moe-16b with its aux
loss).

Tolerances: `byte_corpus_from_text` BITWISE the reference's batches (the
window offsets come from a numpy RandomState seeded by a hash of a tuple of
ints, the same in every Python process); the stub embeds hold their stated
shape, dtype and scale (bf16, standard deviation 0.3 within 5% over 64k
draws, mean within 0.01) and repeat bitwise for the same (seed, step).
"""

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import byte_corpus_from_text as jbyte_corpus
from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                       byte_corpus_from_text)
from repro_torch.launch import train as launch_train

TEXT = ("Quartet II trains language models in NVFP4: four-over-six "
        "forward quantization and an unbiased MS-EDEN backward. ") * 12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_emit_embeds_shape_dtype_scale_and_determinism():
    cfg = DataConfig(vocab=512, seq_len=64, global_batch=8, seed=3,
                     d_model=128, emit_embeds=True)
    corpus = SyntheticCorpus(cfg)
    a, b = corpus.batch_at(2), corpus.batch_at(2)
    emb = a["embeds"]
    assert emb.shape == (8, 64, 128) and emb.dtype == torch.bfloat16
    assert torch.equal(emb, b["embeds"])
    assert not torch.equal(emb, corpus.batch_at(3)["embeds"])
    assert abs(float(emb.float().std()) - 0.3) < 0.05 * 0.3
    assert abs(float(emb.float().mean())) < 0.01
    # the embeds are drawn after the tokens: the token stream is unchanged
    plain = SyntheticCorpus(DataConfig(vocab=512, seq_len=64, global_batch=8,
                                       seed=3)).batch_at(2)
    assert torch.equal(a["tokens"], plain["tokens"])
    assert torch.equal(a["labels"], plain["labels"])
    assert "embeds" not in plain


@pytest.mark.parametrize("seed", [0, 7])
def test_byte_corpus_bitwise_the_reference(seed):
    jc = jbyte_corpus(TEXT, JDataConfig(vocab=256, seq_len=32,
                                        global_batch=4, seed=seed))
    tc = byte_corpus_from_text(TEXT, DataConfig(vocab=256, seq_len=32,
                                                global_batch=4, seed=seed))
    for step in range(3):
        want = jax.tree.map(np.asarray, jc.batch_at(step))
        got = tc.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


@pytest.mark.parametrize("arch", ["llava_next_mistral_7b", "deepseek_moe_16b"])
def test_launch_train_cpu_reduced_new_families(arch):
    out = launch_train.main(["--device", "cpu", "--reduced", "--arch", arch,
                             "--steps", "2", "--seq", "16", "--batch", "2",
                             "--log-every", "100"])
    assert out["arch"].startswith(arch.split("_")[0]) and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))
