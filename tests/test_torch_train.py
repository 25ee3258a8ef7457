"""The port's training path (``repro_torch.training``, ``.data``,
``.distributed.fault_tolerance``, ``.launch.train``) against the
reference's, on the CPU.

Tolerances, each stated where it is used:

  * data batches: bit for bit (the pipeline is numpy, copied);
  * a 3-step ``Trainer`` run from the reference's weights and batches:
    losses within 1e-5 relative in fp32 (``cfg.scaled(dtype="float32")``)
    and within 5e-4 relative at the config's bf16 compute — the first
    step's loss, before any update, already differs by up to 1.6e-4
    there (bf16 roundings of the hidden states, ``test_torch_models``);
  * microbatch accumulation against the whole batch: 1e-4, the
    reference's own bound.
"""

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_smoke_config as ref_smoke
from repro.data import DataConfig as RData
from repro.data import MemmapCorpus as RMemmap
from repro.data import SyntheticLM as RSynthetic
from repro.training import RunConfig as RRun
from repro.training import TrainConfig as RTrain
from repro.training import Trainer as RTrainer
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, MemmapCorpus, SyntheticLM, make_pipeline
from repro_torch.distributed import StepWatchdog
from repro_torch.distributed.fault_tolerance import _median
from repro_torch.launch import train as launcher
from repro_torch.models import init_params
from repro_torch.observability import metrics
from repro_torch.training import (RunConfig, TrainConfig, Trainer,
                                  init_train_state, make_train_step)


def _data(cfg, batch=8, seq=64, cls=DataConfig):
    return cls(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
               embedding_input=cfg.embedding_input, d_model=cfg.d_model)


# ----------------------------------------------------------------- data


@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-large"])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bit_equal(arch, seed):
    cfg = get_smoke_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=48, global_batch=4,
              seed=seed, embedding_input=cfg.embedding_input,
              d_model=cfg.d_model)
    mine, ref = iter(SyntheticLM(DataConfig(**kw))), iter(
        RSynthetic(RData(**kw)))
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_memmap_batches_bit_equal(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 5000).astype(np.int32).tofile(
        path)
    kw = dict(vocab_size=500, seq_len=32, global_batch=3, seed=2,
              path=str(path))
    mine = make_pipeline(DataConfig(**kw))
    assert isinstance(mine, MemmapCorpus)
    ref = iter(RMemmap(RData(**kw)))
    it = iter(mine)
    for _ in range(3):
        a, b = next(it), next(ref)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    assert mine.state_dict() == {"step": 3, "seed": 2}


def test_pipeline_cursor_resumes():
    cfg = get_smoke_config("smollm-135m")
    a = SyntheticLM(_data(cfg))
    it = iter(a)
    next(it), next(it)
    b = SyntheticLM(_data(cfg))
    b.load_state_dict(a.state_dict())
    assert np.array_equal(next(iter(b))["tokens"], a.peek(2)["tokens"])


# -------------------------------------------------------------- trainer


def _ref_run(cfg, tcfg_kw, steps=3):
    tr = RTrainer(cfg, RTrain(**tcfg_kw),
                  RRun(total_steps=steps, warmup_steps=1, log_every=1),
                  _data(cfg, cls=RData), log_fn=lambda s: None)
    start = jax.tree.map(np.asarray, tr.state.params)
    return start, [m["loss"] for m in tr.run()["history"]]


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), (None, 5e-4)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["leafwise", "batched"])
def test_trainer_matches_reference_from_carried_weights(dtype, rtol, batched):
    """Three QR-Muon steps of the smollm-135m smoke model from the
    reference's weights and batches: every loss within ``rtol``."""
    rc, tc = ref_smoke("smollm-135m"), get_smoke_config("smollm-135m")
    if dtype is not None:
        rc, tc = rc.scaled(dtype=dtype), tc.scaled(dtype=dtype)
    kw = dict(optimizer="muon-qr", lr=0.02, batched_ortho=batched)
    start, ref = _ref_run(rc, kw)
    tr = Trainer(tc, TrainConfig(**kw),
                 RunConfig(total_steps=3, warmup_steps=1, log_every=1),
                 _data(tc), device="cpu", log_fn=lambda s: None,
                 params=start)
    mine = [m["loss"] for m in tr.run()["history"]]
    assert len(mine) == len(ref) == 3
    np.testing.assert_allclose(mine, ref, rtol=rtol, atol=0)


def test_trainer_loss_decreases():
    """Twin of ``test_train_integration.py::test_trainer_loss_decreases``."""
    cfg = get_smoke_config("smollm-135m")
    tr = Trainer(cfg, TrainConfig(optimizer="muon-qr", lr=0.02),
                 RunConfig(total_steps=15, warmup_steps=2, log_every=1),
                 _data(cfg), device="cpu", log_fn=lambda s: None)
    res = tr.run()
    losses = [m["loss"] for m in res["history"]]
    assert res["final_step"] == 15 and len(losses) == 15
    assert losses[-1] < losses[0] - 1.0


def test_microbatch_equivalence():
    """Twin of ``test_train_integration.py::test_microbatch_equivalence``:
    accumulation over 2 or 4 microbatches equals the whole batch within
    1e-4 (loss and every updated param)."""
    cfg = get_smoke_config("olmo-1b").scaled(dtype="float32")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (8, 32))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (8, 32)))}
    outs = {}
    for mb in (0, 2, 4):
        model = init_params(torch.Generator().manual_seed(0), cfg)
        tcfg = TrainConfig(optimizer="adamw", lr=1e-3, microbatch=mb)
        state = init_train_state(model, tcfg)
        step = make_train_step(cfg, tcfg, device="cpu")
        state, m = step(state, batch, 1e-3)
        outs[mb] = ({k: p.detach().clone() for k, p in
                     state.params.named_parameters()}, float(m["loss"]))
    for mb in (2, 4):
        assert abs(outs[mb][1] - outs[0][1]) < 1e-4
        assert max(float((outs[mb][0][k] - v).abs().max())
                   for k, v in outs[0][0].items()) < 1e-4


def test_microbatch_rejects_uneven_split():
    cfg = get_smoke_config("smollm-135m")
    tcfg = TrainConfig(microbatch=3)
    state = init_train_state(init_params(torch.Generator().manual_seed(0),
                                         cfg), tcfg)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(_data(cfg)).peek(0).items()}
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(cfg, tcfg, device="cpu")(state, batch, 0.01)


@pytest.mark.parametrize("opt", ["muon-ns", "adamw"])
def test_other_optimizers_train(opt):
    cfg = get_smoke_config("smollm-135m")
    tr = Trainer(cfg, TrainConfig(optimizer=opt, lr=0.02 if "muon" in opt
                                  else 2e-3),
                 RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                 _data(cfg), device="cpu", log_fn=lambda s: None)
    losses = [m["loss"] for m in tr.run()["history"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_trainer_device_and_a14_rules():
    """The trainer runs on "cuda" unless asked, and raises for what waits
    for the distributed layer (ROADMAP A14)."""
    cfg = get_smoke_config("smollm-135m")
    args = (cfg, TrainConfig(), RunConfig(total_steps=1), _data(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(*args)
    with pytest.raises(NotImplementedError, match="A14"):
        Trainer(*args, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="A14"):
        Trainer(cfg, TrainConfig(), RunConfig(checkpoint_dir="/nonexistent"),
                _data(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="A14"):
        Trainer(cfg, TrainConfig(grad_compression=True), RunConfig(),
                _data(cfg), device="cpu")


# ------------------------------------------------------------- launcher


@pytest.mark.parametrize("extra", [[], ["--batched-ortho"],
                                   ["--optimizer", "adamw"]])
def test_launcher_smoke_on_cpu(extra, capsys):
    res = launcher.main(["--arch", "smollm-135m", "--smoke", "--steps", "2",
                         "--device", "cpu"] + extra)
    assert res["final_step"] == 2
    assert '"final_step": 2' in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "2,1"], ["--grad-compression"],
                                  ["--checkpoint-dir", "/nonexistent"]])
def test_launcher_a14_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="A14"):
        launcher.main(["--arch", "smollm-135m", "--smoke", "--steps", "1",
                       "--device", "cpu"] + flag)


# ------------------------------------------------------------- watchdog


class TestWatchdogMedian:
    """Twins of ``tests/test_robustness.py::TestWatchdogMedian``."""

    def test_even_window_uses_true_median(self):
        assert _median([1.0, 2.0, 3.0, 10.0]) == 2.5
        assert _median([1.0, 2.0, 3.0]) == 2.0
        wd = StepWatchdog()
        wd._times = [1.0, 1.0, 1.0, 9.0]
        assert wd.median == 1.0

    def test_straggler_counter_fires(self):
        wd = StepWatchdog(threshold=2.0)
        before = metrics.counter_value("fault.straggler_steps")
        wd._times = [0.1] * 6
        wd._t0 = __import__("time").monotonic() - 1.0
        assert wd.stop(step=7) > 0.5
        assert wd.straggler_steps == [7]
        assert metrics.counter_value("fault.straggler_steps") == before + 1

    def test_trainer_reports_stragglers(self):
        seen = []
        wd = StepWatchdog(threshold=0.0,
                          on_straggler=lambda s, dt, med: seen.append(s))
        cfg = get_smoke_config("smollm-135m")
        tr = Trainer(cfg, TrainConfig(optimizer="adamw"),
                     RunConfig(total_steps=7, warmup_steps=1, log_every=1),
                     _data(cfg, batch=2, seq=16), device="cpu",
                     watchdog=wd, log_fn=lambda s: None)
        res = tr.run()
        assert res["stragglers"] == seen == [5, 6]
