"""Training deepseek-v3 (MLA + MoE) with the port against the JAX reference:
the backward through `mla_apply` and the expert loop. The checks and their
tolerances are tests/test_torch_moe_train.py's (its docstring), run here on
reduced deepseek-v3, there on reduced deepseek-moe-16b."""

import pytest
import torch

from test_torch_moe_train import (check_aux_loss,
                                  check_bf16_loss_and_every_gradient,
                                  check_bf16_train_loop,
                                  check_idle_expert_gradient,
                                  check_quartet2_loss)

ARCH = "deepseek_v3_671b"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_bf16_loss_and_every_gradient_match_eager_jax():
    check_bf16_loss_and_every_gradient(ARCH)


def test_aux_loss_matches_jax():
    check_aux_loss(ARCH)


def test_idle_expert_gradient_is_zero_and_decays():
    check_idle_expert_gradient(ARCH)


def test_bf16_train_loop_matches_jax():
    check_bf16_train_loop(ARCH)


def test_quartet2_loss_within_noise_of_eager_jax():
    check_quartet2_loss(ARCH)
