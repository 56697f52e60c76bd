"""The fixed-batch generation path on reduced deepseek-v3 (MLA + MoE,
capacity factor 8, so no token is dropped) against the JAX reference: the
expanded-form MLA prefill into dense latent caches, the dense branch of
`mla_decode`, `greedy_generate` and the engine over dense caches. The
checks and their tolerances are tests/test_torch_generate.py's: prefill
within one bf16 ulp of the tensor's largest value (bf16) or Q2_REL_RMS
(quartet2) on the tokens no router near-tie reaches; prefill + decode
within 5% of max|logit| of a full train-mode forward; the bf16 greedy streams equal up to
the first eager-reference margin under EAGER_LOGIT_TOL; dense engine
streams bitwise the paged pool's.
"""

import pytest
import torch

import test_torch_generate as G

ARCH = "deepseek_v3_671b"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("scheme", G.SCHEMES)
def test_prefill_logits_and_caches_match_eager_jax(scheme):
    G.prefill_matches_eager_jax(ARCH, scheme)


def test_prefill_then_decode_matches_a_full_forward():
    G.prefill_then_decode_matches_a_full_forward(ARCH)


@pytest.mark.parametrize("scheme", G.SCHEMES)
def test_dense_decode_layer_matches_jax(scheme):
    G.dense_decode_layer_matches_jax(ARCH, scheme)


def test_greedy_generate_matches_eager_jax():
    G.greedy_generate_matches_eager_jax(ARCH, "bf16")


@pytest.mark.parametrize("spec", G.SPEC, ids=["plain", "spec_k3"])
def test_dense_engine_streams_equal_the_paged_engine(spec):
    G.dense_engine_streams_equal_the_paged_engine(ARCH, spec)
