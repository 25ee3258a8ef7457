"""The port's trainer on the recurrent, MoE and embedding-input models
against the reference's, on the CPU.

Twins of ``tests/test_train_integration.py::test_trainer_runs_recurrent_archs``
and ``::test_embedding_input_arch_trains``, at the same smoke size
(batch 4 x 32, lr 0.01 for QR-Muon, 1e-3 for AdamW) in fp32
(``cfg.scaled(dtype="float32")``), held against the reference's losses
from the reference's starting weights (carried by ``params_from_numpy``).

Tolerance, per step: 1e-5 relative, or twice the port's own spread if
that is larger — the spread of a run whose every momentum is scaled by
1 + 2^-23 before its QR (a one-ulp change, as another reduction order
makes).  The losses before the first update (steps 1-2: the warm-up
step's LR is 0) meet 1e-5 on every model.  After it they meet 1e-5 on
jamba, qwen2-moe and musicgen; xlstm's momenta are singular (its mLSTM
``wv`` blocks: fp64 condition numbers to 2e8 in the smoke config), so
the Q columns past their rank are rounding noise and a one-ulp change
moves step 3's loss by about 1e-3 (measured here, each run), as the two
packages' losses part (the first update on the columns the momenta
determine: ``tests/test_torch_lm_grads.py``).
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as ref_smoke
from repro.data import DataConfig as RData
from repro.training import RunConfig as RRun
from repro.training import TrainConfig as RTrain
from repro.training import Trainer as RTrainer
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.optim import qr_muon
from repro_torch.training import RunConfig, TrainConfig, Trainer

STEPS = 3
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _data(cfg, cls):
    return cls(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
               embedding_input=cfg.embedding_input, d_model=cfg.d_model)


def _port_losses(cfg, tkw, start, ulp=False):
    real = qr_muon._local_orthogonalizer

    def one_ulp(*a, **k):
        f = real(*a, **k)
        return lambda x: f(x * (1 + 2 ** -23))

    if ulp:
        qr_muon._local_orthogonalizer = one_ulp
    try:
        tr = Trainer(cfg, TrainConfig(**tkw),
                     RunConfig(total_steps=STEPS, warmup_steps=1,
                               log_every=1),
                     _data(cfg, DataConfig), device="cpu",
                     log_fn=lambda s: None, params=start)
        return np.array([m["loss"] for m in tr.run()["history"]])
    finally:
        qr_muon._local_orthogonalizer = real


def check_trainer_twin(arch, tkw):
    """``STEPS`` steps of the port's trainer from the reference trainer's
    starting weights, against the reference's losses."""
    rc = ref_smoke(arch).scaled(dtype="float32")
    tc = get_smoke_config(arch).scaled(dtype="float32")
    tr = RTrainer(rc, RTrain(**tkw),
                  RRun(total_steps=STEPS, warmup_steps=1, log_every=1),
                  _data(rc, RData), log_fn=lambda s: None)
    start = jax.tree.map(np.asarray, tr.state.params)
    ref = np.array([m["loss"] for m in tr.run()["history"]])
    mine = _port_losses(tc, tkw, start)
    assert len(mine) == len(ref) == STEPS
    assert np.isfinite(mine).all()
    rel = np.abs(mine - ref) / np.abs(ref)
    assert (rel[:2] <= RTOL).all(), rel
    if arch != "xlstm-1.3b":
        assert (rel <= RTOL).all(), rel
        return
    spread = np.abs(_port_losses(tc, tkw, start, ulp=True) - mine) \
        / np.abs(mine)
    assert (rel <= np.maximum(RTOL, 2 * spread)).all(), (rel, spread)


@pytest.mark.parametrize("arch,tkw", [
    ("jamba-v0.1-52b", dict(optimizer="muon-qr", lr=0.01)),
    ("qwen2-moe-a2.7b", dict(optimizer="muon-qr", lr=0.01)),
    ("musicgen-large", dict(optimizer="adamw", lr=1e-3)),
], ids=["jamba", "qwen2-moe", "musicgen-embeds"])
def test_trainer_matches_reference_from_carried_weights(arch, tkw):
    """xlstm's twin is in ``tests/test_torch_lm_plans.py`` (each file
    compiles the reference's trainer once a model)."""
    check_trainer_twin(arch, tkw)
