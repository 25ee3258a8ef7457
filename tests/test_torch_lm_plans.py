"""QR-Muon's shape classes on the full-width models, the period-stacked
expert stacks, the checkpointed recurrences, the training launcher on
every architecture, and xlstm's trainer twin — the port against the
reference, on the CPU.

  * ``plan_batched_ortho`` over every Muon leaf of each of the ten
    architectures at full width (shapes only: the port's ``init_params``
    on the ``meta`` device, the reference's through ``jax.eval_shape``):
    the same classes (padded key, dtype), the same members (by leaf name
    and index), routes, methods and dispatch modes, on the CPU backend.
    The only difference allowed is ROADMAP C5: the reference also sends
    the period-stacked vectors (norm gains, biases: ``(n_periods, d)``
    leaves) of a model with 8 or more periods to Muon; the port does not.
  * A 4-D ``(n_periods, E, d, d_e)`` expert stack unrolls row-major into
    its members, and its orthogonalization equals each matrix's own bit
    for bit, and the reference's within 100 eps max(m, n).
  * The mLSTM, sLSTM and mamba scans, chunked and recomputed in the
    backward pass when autograd records, equal the same loop without
    recomputation bit for bit (outputs and every input's gradient).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.models import init_params as jinit
from repro.optim import batched_ortho as RB
from repro.optim.qr_muon import is_muon_param as j_is_muon
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.launch.roofline import _meta_params
from repro_torch.models import layers, ssm, xlstm
from repro_torch.optim import (batched_orthogonalize, is_muon_param,
                               plan_batched_ortho, qr_orthogonalize_2d)
from test_torch_lm_training import check_trainer_twin

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rows(plan, names):
    """Each class as (key, sorted (leaf name, index) members, route,
    method, dispatch mode)."""
    counts = {}
    members = []
    for leaf in plan.member_leaf:
        members.append((names[leaf], counts.get(leaf, 0)))
        counts[leaf] = counts.get(leaf, 0) + 1
    return sorted(((c.key.m, c.key.n, str(c.key.dtype)),
                   tuple(sorted(members[i] for i in c.members)),
                   c.route, c.method, c.dispatch_mode)
                  for c in plan.classes)


@pytest.mark.parametrize("arch", ARCHS)
def test_class_plans_match_reference_at_full_width(arch):
    shapes = jax.eval_shape(lambda k: jinit(k, jget(arch)),
                            jax.ShapeDtypeStruct((2,), np.uint32))
    ref, c5 = [], []
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        if not j_is_muon(path, leaf):
            continue
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        if path[0].key == "layers" and leaf.ndim == 2:
            c5.append(name)                  # a period-stacked vector
            continue
        ref.append((name, tuple(leaf.shape)))
    mine = [(n, tuple(p.shape)) for n, p in
            _meta_params(get_config(arch)).named_parameters()
            if is_muon_param(n, p)]
    assert sorted(mine) == sorted(ref)
    assert bool(c5) == (get_config(arch).n_periods >= 8 and any(
        n.startswith("layers") and p.ndim == 2 and min(p.shape) >= 8
        for n, p in _meta_params(get_config(arch)).named_parameters()))
    rplan = RB.plan_batched_ortho([(s, np.float32) for _, s in ref],
                                  backend="cpu")
    mplan = plan_batched_ortho([(s, torch.float32) for _, s in mine],
                               backend="cpu")
    assert _rows(mplan, [n for n, _ in mine]) == \
        _rows(rplan, [n for n, _ in ref])
    assert (mplan.dispatches, mplan.n_matrices) == (rplan.dispatches,
                                                    rplan.n_matrices)


def test_expert_stacks_route_on_the_card():
    """qwen2-moe-a2.7b cut to 2 layers (the card's training cell): the
    (2, 60, 2048, 1408) gate/up stacks and (2, 60, 1408, 2048) down stacks
    form one class of 360 members on the wavefront rung (its 64 x 44 task
    table is past the megakernel's budget)."""
    cfg = get_config("qwen2-moe-a2.7b").scaled(n_layers=2)
    leaves = [(tuple(p.shape), torch.float32) for n, p in
              _meta_params(cfg).named_parameters() if is_muon_param(n, p)]
    plan = plan_batched_ortho(leaves, backend="cuda")
    classes = {f"{c.key.m}x{c.key.n}": (len(c.members), c.method,
                                        c.dispatch_mode)
               for c in plan.classes}
    assert classes == {"2048x1408": (360, "tiled", "wavefront"),
                       "2048x2048": (8, "tiled", "wavefront"),
                       "5632x2048": (6, "geqrf_ht", None)}
    assert plan.dispatches == 3


def test_four_d_expert_stack_unrolls_row_major():
    """A (2, 3, 48, 32) stack: 6 members, row-major; each O the
    matrix's own O bit for bit, and the reference's within 100 eps
    max(m, n) (elementwise)."""
    assert is_muon_param("layers.0.moe.gate_w",
                         torch.empty((2, 3, 48, 32), device="meta"))
    a = np.random.default_rng(0).standard_normal((2, 3, 48, 32)).astype(
        np.float32)
    plan = plan_batched_ortho([(a.shape, torch.float32)], backend="cpu")
    assert plan.n_matrices == 6 and plan.member_leaf == (0,) * 6
    (got,) = batched_orthogonalize([torch.from_numpy(a)], device="cpu")
    for i, j in np.ndindex(2, 3):
        own = qr_orthogonalize_2d(torch.from_numpy(a[i, j]))
        assert torch.equal(got[i, j], own)
    (ref,) = RB.batched_orthogonalize([jnp.asarray(a)], backend="cpu")
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 100 * EPS32 * 48


def _plain_checkpoint(monkeypatch):
    """``scan_chunks`` without recomputation: the same loop."""
    import torch.utils.checkpoint as tuc

    monkeypatch.setattr(tuc, "checkpoint",
                        lambda fn, *a, use_reentrant=None: fn(*a))


def _run_mixer(fn, p, x):
    leaves = [x] + [t for t in _tensors(p)]
    y = fn(p, x)
    grads = torch.autograd.grad(y.square().sum(), leaves,
                                allow_unused=True, materialize_grads=True)
    return y.detach(), grads


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


@pytest.mark.parametrize("mixer", ["mlstm", "slstm", "mamba"])
def test_checkpointed_recurrence_equals_unchunked_loop(mixer, monkeypatch):
    """64 tokens in chunks of 16, recomputed in the backward pass,
    against the same loop run without recomputation: the outputs and the
    gradients of the input and every parameter bit for bit (fp32)."""
    arch = "jamba-v0.1-52b" if mixer == "mamba" else "xlstm-1.3b"
    cfg = get_smoke_config(arch).scaled(dtype="float32", seq_chunk=16)
    gen = torch.Generator().manual_seed(0)
    init, fwd = {"mlstm": (xlstm.mlstm_init, xlstm.mlstm_forward),
                 "slstm": (xlstm.slstm_init, xlstm.slstm_forward),
                 "mamba": (ssm.mamba_init, ssm.mamba_forward)}[mixer]
    p = init(gen, cfg)
    for t in _tensors(p):
        t.requires_grad_(True)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, requires_grad=True)
    y, grads = _run_mixer(lambda p, x: fwd(p, x, cfg), p, x)
    _plain_checkpoint(monkeypatch)
    y0, grads0 = _run_mixer(lambda p, x: fwd(p, x, cfg), p, x)
    assert torch.equal(y, y0)
    assert all(torch.equal(g, g0) for g, g0 in zip(grads, grads0))


def test_scan_chunks_recomputes_only_under_autograd(monkeypatch):
    """The chunk rule is the reference's (``min(chunk, S)`` halved until
    it divides S), and ``torch.utils.checkpoint`` runs only when autograd
    records."""
    import torch.utils.checkpoint as tuc

    calls = []
    real = tuc.checkpoint
    monkeypatch.setattr(tuc, "checkpoint", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])

    def body(c, x):
        return c + x.sum(1), x * 2

    x = torch.ones((1, 24, 3), requires_grad=True)
    c, y = layers.scan_chunks(body, torch.zeros((1, 3)), (x,), 16)
    assert len(calls) == 3 and tuple(y.shape) == (1, 24, 3)  # chunks of 8
    with torch.no_grad():
        layers.scan_chunks(body, torch.zeros((1, 3)), (x,), 16)
    assert len(calls) == 3
    assert layers.chunk_size(16, 24) == 8 and layers.chunk_size(512, 256) == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_every_arch(arch, capsys):
    """``python -m repro_torch.launch.train --arch ... --batched-ortho``
    at smoke size on the CPU: one QR-Muon step, a finite loss."""
    res = launcher.main(["--arch", arch, "--smoke", "--steps", "1",
                         "--batch", "2", "--seq", "16", "--device", "cpu",
                         "--batched-ortho"])
    assert res["final_step"] == 1
    assert np.isfinite(res["history"][0]["loss"])


def test_xlstm_trainer_matches_reference_from_carried_weights():
    """Twin of ``test_trainer_runs_recurrent_archs[xlstm-1.3b]``, held as
    ``tests/test_torch_lm_training.py`` holds the others."""
    check_trainer_twin("xlstm-1.3b", dict(optimizer="muon-qr", lr=0.01))
