"""The rest of a run without the look for a card, at the configurations'
smoke sizes on the CPU, with the timed path broken underneath: each
fault a cell can have turns ``correct`` false."""

import pytest
import torch

from perfbench import bench

TRAIN = ["qwen2-moe-a2.7b.train-b8x256", "xlstm-1.3b.train-b16x256"]
DECODE = "xlstm-1.3b.decode-b128-p128"


# The decode cell's embedding drawn at d_model^-1/2, as its traffic file
# has it for the published width, at the smoke width.
SMOKE_DECODE = {"weight_scales": {"embed.table": 64 ** -0.5}}


def _run(name, **traffic):
    cell = bench.Cell(name, seed=2147483711, seconds=0.5, trace=False, device="cpu", smoke=True)
    cell.traffic = dict(cell.traffic, **traffic)
    return bench.run(cell)


def _wrap_step(monkeypatch, wrap):
    from repro_torch.training import trainer as trainer_mod

    real = trainer_mod.make_train_step
    monkeypatch.setattr(trainer_mod, "make_train_step",
                        lambda *a, **kw: wrap(real(*a, **kw)))


def unchanged(step):
    """A step that returns the state it was given."""
    def run(state, batch, lr):
        saved = {k: p.detach().clone() for k, p in state.params.named_parameters()}
        _, metrics = step(state, batch, lr)
        with torch.no_grad():
            for k, p in state.params.named_parameters():
                p.copy_(saved[k])
        return state, metrics
    return run


def half_batch(step):
    """Half of each batch left out, the mean taken over the rest."""
    def run(state, batch, lr):
        n = batch["labels"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()}, lr)
    return run


def altered_update(monkeypatch):
    """The orthogonalized update altered where it is produced."""
    from repro_torch.optim import batched_ortho

    real = batched_ortho.batched_orthogonalize
    monkeypatch.setattr(batched_ortho, "batched_orthogonalize",
                        lambda *a, **kw: [2.0 * o for o in real(*a, **kw)])


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered_update"])
def test_train_fault_is_not_correct(monkeypatch, name, fault):
    if fault == "altered_update":
        altered_update(monkeypatch)
    else:
        _wrap_step(monkeypatch, {"unchanged": unchanged, "half_batch": half_batch}[fault])
    out = _run(name, batch=8, seq=32)
    assert out["checks"] and out["correct"] is False, out["readings"]


def _patch_serve_step(monkeypatch, wrap):
    from repro_torch.serving import engine

    real = engine.serve_step
    monkeypatch.setattr(engine, "serve_step", wrap(real))


def state_unchanged(real):
    def step(params, tok, cfg, caches, pos):
        return real(params, tok, cfg, caches, pos)[0], caches
    return step


def half_left_out(real):
    def step(params, tok, cfg, caches, pos):
        logits, new = real(params, tok, cfg, caches, pos)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, new
    return step


def altered_token(monkeypatch):
    from repro_torch.serving import ServeEngine

    real = ServeEngine.sample
    monkeypatch.setattr(ServeEngine, "sample",
                        lambda self, logits: (real(self, logits) + 1) % logits.shape[-1])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "altered_token"])
def test_decode_fault_is_not_correct(monkeypatch, fault):
    if fault == "altered_token":
        altered_token(monkeypatch)
    else:
        _patch_serve_step(monkeypatch, {"state_unchanged": state_unchanged,
                                        "half_left_out": half_left_out}[fault])
    out = _run(DECODE, **SMOKE_DECODE)
    assert out["checks"] and out["correct"] is False, out["readings"]


def test_sound_decode_is_correct():
    out = _run(DECODE, **SMOKE_DECODE)
    assert out["correct"] is True, out["readings"]
