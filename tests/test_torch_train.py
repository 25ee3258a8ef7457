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
from worker_threads import share_the_cores  # noqa: F401  (autouse)


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


def test_trainer_device_and_a14_rules(tmp_path):
    """The trainer runs on "cuda" unless asked; checkpoints and gradient
    compression (ROADMAP A14) are ported; and so is mesh training
    (ROADMAP A21): on a (1, 1) mesh of one gloo rank the state is placed
    as DTensors and two steps give the mesh-free run's losses bit for
    bit; a mesh of another device type is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import MeshRules

    cfg = get_smoke_config("smollm-135m")
    args = (cfg, TrainConfig(), RunConfig(total_steps=1), _data(cfg))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(*args)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        runs = []
        for kw in ({}, {"mesh": mesh}, {"rules": MeshRules(mesh)}):
            tr = Trainer(cfg, TrainConfig(qr_shard_leaves=True),
                         RunConfig(total_steps=2, warmup_steps=1,
                                   log_every=1),
                         _data(cfg), device="cpu", log_fn=lambda s: None,
                         params=init_params(torch.Generator().manual_seed(0),
                                            cfg), **kw)
            placed = [isinstance(p, DTensor)
                      for _, p in tr.state.params.named_parameters()]
            assert all(placed) if kw else not any(placed)
            runs.append([m["loss"] for m in tr.run()["history"]])
        assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 2
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="mesh is on"):
                Trainer(*args, mesh=mesh)
    finally:
        dist.destroy_process_group()
    tr = Trainer(cfg, TrainConfig(),
                 RunConfig(total_steps=1, checkpoint_dir=str(tmp_path)),
                 _data(cfg), device="cpu", log_fn=lambda s: None)
    assert tr.run()["final_step"] == 1 and tr.ckpt.latest_step() == 1
    tr = Trainer(cfg, TrainConfig(grad_compression=True),
                 RunConfig(total_steps=1), _data(cfg), device="cpu",
                 log_fn=lambda s: None)
    assert set(tr.state.ef_error) == {k for k, _ in
                                      tr.state.params.named_parameters()}
    assert np.isfinite(tr.run()["history"][0]["loss"])


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "grad_compression"])
def test_restart_is_bitexact_continuation(compression, tmp_path):
    """Twin of ``test_train_integration.py::
    test_trainer_restart_is_bitexact_continuation`` (6 steps, a crash at
    4, checkpoints every 2): the restored state equals the saved one bit
    for bit — every tensor of the parameters, the optimizer state and the
    error-feedback residuals, the step index and the data cursor — and
    the resumed run's losses equal the uninterrupted run's (the
    reference's bar is 1e-3; on the CPU the bits agree)."""
    from repro_torch.checkpoint.manager import _leaves_with_path

    cfg = get_smoke_config("smollm-135m")
    tcfg = TrainConfig(optimizer="muon-qr", lr=0.02, batched_ortho=True,
                       grad_compression=compression)

    def run_cfg(ckpt):
        return RunConfig(total_steps=6, warmup_steps=1, log_every=1,
                         checkpoint_every=2, checkpoint_dir=ckpt)

    def trainer(ckpt=None):
        return Trainer(cfg, tcfg, run_cfg(ckpt), _data(cfg), device="cpu",
                       log_fn=lambda s: None)

    crashed = trainer(str(tmp_path))
    crashed.run(stop_at=4)
    saved = list(_leaves_with_path(crashed.checkpoint_tree()))
    resumed = trainer(str(tmp_path))
    assert resumed.maybe_restore() and resumed.step_idx == 4
    assert resumed.pipeline.state_dict() == crashed.pipeline.state_dict()
    got = list(_leaves_with_path(resumed.checkpoint_tree()))
    assert [k for k, _ in got] == [k for k, _ in saved]
    assert any(k.startswith(".ef_error[") for k, _ in got) == compression
    for (k, x), (_, y) in zip(got, saved):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        assert same, k
    tail = [m["loss"] for m in resumed.run(resume=False)["history"]]
    whole = [m["loss"] for m in trainer().run()["history"]]
    assert tail == whole[4:]


def test_training_with_compression_converges():
    """Twin of ``test_train_integration.py::
    test_training_with_compression_converges``: 12 AdamW steps with the
    int8 error-feedback codec lower the loss."""
    cfg = get_smoke_config("smollm-135m")
    tr = Trainer(cfg, TrainConfig(optimizer="adamw", lr=2e-3,
                                  grad_compression=True),
                 RunConfig(total_steps=12, warmup_steps=2, log_every=1),
                 _data(cfg), device="cpu", log_fn=lambda s: None)
    losses = [m["loss"] for m in tr.run()["history"]]
    assert losses[-1] < losses[0] - 0.5
    assert np.isfinite(losses).all()


def test_grad_compression_matches_reference_from_carried_weights():
    """Three QR-Muon steps with ``grad_compression`` from the reference's
    weights and batches (fp32): every loss within 1e-4 relative of the
    reference's (the uncompressed run's 1e-5, with room for an int8 code
    that rounds the other way on an ulp of gradient)."""
    rc = ref_smoke("smollm-135m").scaled(dtype="float32")
    tc = get_smoke_config("smollm-135m").scaled(dtype="float32")
    kw = dict(optimizer="muon-qr", lr=0.02, grad_compression=True)
    start, ref = _ref_run(rc, kw)
    tr = Trainer(tc, TrainConfig(**kw),
                 RunConfig(total_steps=3, warmup_steps=1, log_every=1),
                 _data(tc), device="cpu", log_fn=lambda s: None,
                 params=start)
    mine = [m["loss"] for m in tr.run()["history"]]
    assert len(mine) == len(ref) == 3
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=0)


# ------------------------------------------------------------- launcher


@pytest.mark.parametrize("extra", [[], ["--batched-ortho"],
                                   ["--optimizer", "adamw"]])
def test_launcher_smoke_on_cpu(extra, capsys):
    res = launcher.main(["--arch", "smollm-135m", "--smoke", "--steps", "2",
                         "--device", "cpu"] + extra)
    assert res["final_step"] == 2
    assert '"final_step": 2' in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "2,1"], ["--grad-compression"],
                                  ["--checkpoint-dir", "CKPT"]])
def test_launcher_a14_flags_raise(flag, tmp_path, capsys):
    """``--grad-compression`` and ``--checkpoint-dir`` (ROADMAP A14) run
    (a second launch resumes from the checkpoint); ``--mesh 2,1`` (ROADMAP
    A21) runs on two gloo ranks, each a launcher process joined through a
    ``file://`` store, and both print the same losses."""
    base = ["--arch", "smollm-135m", "--smoke", "--steps", "1", "--device",
            "cpu"]
    flag = [str(tmp_path) if f == "CKPT" else f for f in flag]
    if flag[0] == "--mesh":
        _two_launcher_ranks(base + flag + ["--steps", "2"], tmp_path)
        return
    assert launcher.main(base + flag)["final_step"] == 1
    if flag[0] == "--checkpoint-dir":
        capsys.readouterr()
        assert launcher.main(base[:4] + ["2"] + base[5:] + flag)[
            "final_step"] == 2
        assert "[trainer] restored step 1" in capsys.readouterr().out


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


def _two_launcher_ranks(argv, tmp_path):
    """``python -m repro_torch.launch.train argv`` as two gloo ranks: both
    finish and report the same last step."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + argv + [
            "--init-method", f"file://{tmp_path}/store", "--rank", str(r),
            "--world-size", "2"],
        env=env, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    last = [json.loads([line for line in log.splitlines()
                        if line.startswith('{"final_step"')][-1])
            for log in logs]
    assert last[0]["final_step"] == last[1]["final_step"] == 2
    assert last[0]["last"]["loss"] == last[1]["last"]["loss"]
