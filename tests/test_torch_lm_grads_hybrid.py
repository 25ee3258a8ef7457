"""Loss, every gradient and the first QR-Muon update of jamba (mamba,
attention and MoE) and qwen2-moe against the reference's, on the CPU:
the checks and gates of ``tests/test_torch_lm_grads.py`` (its docstring
states them and the measured noise), on the other two models.
"""

import pytest
import torch

from test_torch_lm_grads import check_first_update, check_gradients

ARCHS = ["jamba-v0.1-52b", "qwen2-moe-a2.7b"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_within_reference_noise(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_muon_update_matches_reference(arch):
    check_first_update(arch)
