"""The benchmark's plain reference against the program's plain path, at
the configurations' smoke sizes on the CPU: the parameter tree, the
forward pass and loss with their gradients (the program run in float32),
and the QR-Muon update."""

import dataclasses
import math

import pytest
import torch

from perfbench import bench
from perfbench.reference import compare, inputs, model, muon

CONFIGS = {"qwen2-moe-a2.7b": "qwen2-moe-a2.7b.train-b8x256",
           "xlstm-1.3b": "xlstm-1.3b.train-b16x256"}


def _cell(name):
    return bench.Cell(CONFIGS[name], seed=7, seconds=1, trace=False, device="cpu", smoke=True)


def _port(cell, dtype="float32"):
    from repro_torch.models import ParamTree

    cfg = dataclasses.replace(cell.port_config(), dtype=dtype)
    ref_cfg = cell.ref_config()
    tree = inputs.weights(model.param_spec(ref_cfg), 7, "cpu")
    return cfg, ref_cfg, tree, ParamTree(tree)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_tree_matches_program(name):
    from repro_torch.models import init_params

    cell = _cell(name)
    port = init_params(torch.Generator().manual_seed(0), cell.port_config())
    want = {k: tuple(p.shape) for k, p in port.named_parameters()}
    got = {k: i.shape for k, i in model.leaves(model.param_spec(cell.ref_config()))}
    assert got == want


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_gradients_match_program(name):
    from repro_torch.training import TrainConfig
    from repro_torch.training.train_step import _loss_fn

    cell = _cell(name)
    cfg, ref_cfg, tree, params = _port(cell)
    b = inputs.train_batch(7, 0, 2, 16, ref_cfg.vocab_size)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    loss_p, _ = _loss_fn(params, batch, cfg, TrainConfig())
    grads_p = torch.autograd.grad(loss_p, list(params.parameters()))
    named = dict(model.leaves(tree))
    for t in named.values():
        t.requires_grad_(True)
    loss_r = model.loss(tree, batch, ref_cfg)
    grads_r = torch.autograd.grad(loss_r, list(named.values()))
    assert abs(float(loss_p.detach()) - float(loss_r.detach())) <= 1e-5 * abs(float(loss_r.detach()))
    grads_p = dict(zip((k for k, _ in params.named_parameters()), grads_p))
    for k, gr in zip(named, grads_r):
        gp = grads_p[k]
        scale = float(gr.abs().max()) + 1e-12
        assert float((gp - gr).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_program(name):
    from repro_torch.models import forward_train

    cell = _cell(name)
    cfg, ref_cfg, tree, params = _port(cell)
    tokens = inputs.prompts(7, 2, 24, ref_cfg.vocab_size, "cpu")
    with torch.no_grad():
        lp, _ = forward_train(params, {"tokens": tokens}, cfg)
        lr = model.logits(tree, tokens, ref_cfg)
    assert float((lp - lr).abs().max()) <= 1e-4 * float(lr.abs().max())


def test_qr_muon_update_matches_program():
    from repro_torch.optim import muon_init, muon_update

    cell = _cell("qwen2-moe-a2.7b")
    _, ref_cfg, tree, _ = _port(cell)
    named = {k: t.clone() for k, t in model.leaves(tree)}
    gen = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(t.shape, generator=gen) * 0.01 for k, t in named.items()}
    new_p, _ = muon_update(grads, muon_init(named), named, lr=0.02, device="cpu")
    ref = {k: t.clone() for k, t in named.items()}
    muon.update(ref, grads, muon.init_state(ref), 0.02)
    for k in named:
        assert float((new_p[k] - ref[k]).abs().max()) <= 1e-5, k


def test_orthogonalize_sign_convention():
    a = torch.randn(3, 40, 12, dtype=torch.float64)
    o = muon.orthogonalize(a)
    eye = torch.eye(12, dtype=torch.float64)
    assert torch.allclose(o.mT @ o, eye.expand(3, 12, 12), atol=1e-12)
    assert bool((torch.diagonal(o.mT @ a, dim1=-2, dim2=-1) >= 0).all())
    w = muon.orthogonalize(a.mT)
    assert torch.allclose(w, o.mT)


def test_follow_training_reproduces_program_steps():
    """Three program steps in float32 from the same weights and batches:
    the readings are at float32 round-off.  Each expert sees more tokens
    than it has columns, so its momenta are of full rank and their Q is
    determined."""
    from repro_torch.data import DataConfig
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    cell = _cell("qwen2-moe-a2.7b")
    cfg, ref_cfg, tree, params = _port(cell)
    t = dict(cell.traffic, batch=8, seq=64)
    tr = Trainer(cfg, TrainConfig(optimizer="muon-qr", lr=t["lr"]),
                 RunConfig(total_steps=t["total_steps"], warmup_steps=0, log_every=1),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=7),
                 device="cpu", log_fn=lambda m: None, params=params)
    train = cell.kind
    prog = train.follow(dict_cell(cell, t), tr, 7)
    ref = compare.follow_training(ref_cfg, 7, t, "cpu", against=prog.pop("grads"))
    r = compare.train_readings(prog, ref, ref["diff_norms"])
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["change_gap"] < 1e-3, r
    assert r["grad_diff"] < 1e-4, r
    assert all(math.isfinite(x) for x in ref["losses"])


def dict_cell(cell, traffic):
    """``cell`` with other traffic parameters."""
    cell.traffic = traffic
    return cell
