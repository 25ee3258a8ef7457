"""Loss, every gradient and the first QR-Muon update of the recurrent and
MoE models (xlstm, jamba, qwen2-moe, phi3.5-moe) against the
reference's, on the CPU, in fp32 (``cfg.scaled(dtype="float32")``), from
the reference's weights (``params_from_numpy``) and numpy-seeded tokens
(batch 2 x 64).

**The gradient gate is the reference's own fp32 noise.**  Two probes of
the reference, each computing the same function another way:

  * the batch probe: the same two examples tiled into a batch of 4 (other
    reduction lengths; the mean loss and its gradients are unchanged);
  * the one-ulp probe: every weight scaled by 1 +/- 2^-23 (seeded signs),
    the change another rounding of the weights makes.

``noise`` is the larger of the two probes' largest relative change over
the loss and the gradient leaves (each leaf against its largest entry),
and the gate is ``min(4 * noise, 1e-4)``.  The MoE models run at
capacity factor 8.0 so that no token is dropped at either batch size
(at 1.25 a batch of 4 keeps tokens a batch of 2 drops: another function);
their default capacity is held by the trainer twins' losses
(``tests/test_torch_lm_training.py``).

Measured on the CPU (noise = batch probe / one-ulp probe; the port's
largest gap; the gate; the gradients rounded to bf16, the control):

  * xlstm:      8.5e-7 / 5.2e-5;  gap 2.0e-5 (an mLSTM ``wk``);  1e-4;
    control 3.7e-3;
  * jamba:      6.3e-7 / 4.9e-6;  gap 4.2e-6;  1.9e-5;  control 3.8e-3;
  * qwen2-moe:  7.6e-7 / 1.2e-6;  gap 8.9e-7;  4.8e-6;  control 3.3e-3;
  * phi3.5-moe: 5.1e-7 / 8.4e-7;  gap 7.8e-7;  3.4e-6;  control 3.1e-3.

The batch probe alone misses xlstm's noise: on the CPU each example's
arithmetic does not depend on the batch size, so it sees only the weight
gradients' longer sums, while a one-ulp change of the weights moves the
mLSTM's exponentially gated recurrence's ``wq``/``wk`` gradients by
5.2e-5 — more than the port's gap (ROADMAP A16.1, settled: rounding, not
a fault).

**The first update** (``muon_update`` of the reference on its gradients,
of the port on its own, lr 0.02) is compared leaf by leaf on the columns
the momenta determine: each Muon matrix in the tall orientation the QR
factors, its leading columns whose fp64 R diagonal stays within 100 of
its largest entry so far (QR's first k Q columns depend on the first k
columns of the momentum only; past those the momenta are near singular
— xlstm's ``wv`` blocks reach fp64 condition numbers of 2e8 — and the
Q columns follow the rounding, as they do between two correct runs).
Gate: 1e-4 relative (Frobenius) per leaf; the port's update rounded to
TF32 fails it on every leaf.  Measured: the largest gap 2.1e-5 (xlstm;
9.1e-6 jamba), the control at least 1.9e-4; at a bound of 1e3 xlstm's
gap reaches 1.0e-4, at 300 4.7e-5 (the gap grows with the columns'
condition, as perturbed Q factors' do).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.optim import qr_muon as RQ
from repro.training.train_step import fused_lm_loss as ref_loss
from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_numpy
from repro_torch.models import transformer as TT
from repro_torch.optim import qr_muon as TQ
from repro_torch.training.train_step import fused_lm_loss

#: This file's models; ``test_torch_lm_grads_hybrid.py`` holds jamba and
#: qwen2-moe with the same checks (two files: each compiles the
#: reference's gradient twice a model).
ARCHS = ["xlstm-1.3b", "phi3.5-moe-42b-a6.6b"]
GATE_MAX = 1e-4
UPDATE_RTOL = 1e-4
DET_COND = 100.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(arch):
    rc = ref_smoke(arch).scaled(dtype="float32")
    tc = get_smoke_config(arch).scaled(dtype="float32")
    if rc.moe is not None:
        rc = rc.scaled(moe=dataclasses.replace(rc.moe, capacity_factor=8.0))
        tc = tc.scaled(moe=dataclasses.replace(tc.moe, capacity_factor=8.0))
    return rc, tc


def _batch(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.embedding_input:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    return out


def _flat(tree, prefix=""):
    out = {}
    items = enumerate(tree) if isinstance(tree, tuple) else tree.items()
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, (dict, tuple)):
            out.update(_flat(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _worst(loss, grads, ref_loss_, ref_grads):
    return max([abs(loss - ref_loss_) / abs(ref_loss_)]
               + [_rel(grads[k], g) for k, g in ref_grads.items()])


@functools.lru_cache(maxsize=None)
def reference_run(arch):
    """The reference's weights, loss and gradients, its two noise probes,
    and the port's loss and gradients, for ``arch``."""
    rc, tc = _configs(arch)
    params = RT.init_params(jax.random.PRNGKey(0), rc)

    def fn(p, batch):
        x, aux = RT.forward_hidden(p, batch, rc)
        nll, _ = ref_loss(x, RT.lm_head_weight(p, rc), batch["labels"],
                          logit_softcap=rc.logit_softcap, chunk=16)
        return nll + aux

    grad = jax.jit(jax.value_and_grad(fn))
    batch = _batch(rc)

    def ref(p, b):
        loss, g = grad(p, {k: jnp.asarray(v) for k, v in b.items()})
        return float(loss), _flat(jax.tree.map(np.asarray, g))

    rl, rg = ref(params, batch)
    bl, bg = ref(params, {k: np.concatenate([v, v]) for k, v in batch.items()})
    rng = np.random.default_rng(5)
    ulp = jax.tree.map(lambda a: a * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape)).astype(np.float32), params)
    ul, ug = ref(ulp, batch)
    model = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, aux = TT.forward_hidden(model, tb, tc)
    nll, _ = fused_lm_loss(x, TT.lm_head_weight(model, tc), tb["labels"],
                           logit_softcap=tc.logit_softcap, chunk=16)
    loss = nll + aux
    names, leaves = zip(*model.named_parameters())
    pg = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    return dict(params=params, ref_loss=rl, ref_grads=rg,
                batch_noise=_worst(bl, bg, rl, rg),
                ulp_noise=_worst(ul, ug, rl, rg),
                loss=float(loss.detach()),
                grads={k: g.detach().numpy() for k, g in zip(names, pg)})


def check_gradients(arch):
    """The loss and every gradient leaf within the noise gate, the bf16
    control failing it."""
    r = reference_run(arch)
    noise = max(r["batch_noise"], r["ulp_noise"])
    gate = min(4 * noise, GATE_MAX)
    assert 0 < noise
    assert set(r["grads"]) == set(r["ref_grads"])
    assert abs(r["loss"] - r["ref_loss"]) <= gate * abs(r["ref_loss"])
    gaps = {k: _rel(r["grads"][k], g) for k, g in r["ref_grads"].items()}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= gate, (worst, gaps[worst], gate, r["batch_noise"],
                                 r["ulp_noise"])
    control = max(_rel(torch.from_numpy(r["grads"][k]).bfloat16().float()
                       .numpy(), g) for k, g in r["ref_grads"].items())
    assert control > gate, ("the bf16 control passed", control, gate)


def _unflat_like(tree, flat, prefix=""):
    """The flat ``name -> array`` dict as a tree shaped like ``tree``."""
    if isinstance(tree, dict):
        return {k: _unflat_like(v, flat, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_unflat_like(v, flat, f"{prefix}{i}.")
                     for i, v in enumerate(tree))
    return jnp.asarray(flat[prefix[:-1]])


def _tall(x):
    x = np.asarray(x, np.float64)
    return np.swapaxes(x, -1, -2) if x.shape[-2] < x.shape[-1] else x


def _determined(a):
    """The leading columns whose fp64 R diagonal stays within DET_COND of
    its largest entry so far, for one tall matrix."""
    d = np.abs(np.diagonal(np.linalg.qr(a, mode="r"), axis1=-2, axis2=-1))
    ok = d * DET_COND >= np.maximum.accumulate(d)
    return int(np.argmin(ok)) if not ok.all() else len(d)


def _tf32(x):
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).view(np.float32)


def check_first_update(arch):
    """Each Muon leaf's first update within UPDATE_RTOL of the
    reference's on the determined columns, the TF32 control failing."""
    r = reference_run(arch)
    params = r["params"]
    ref_grads = _unflat_like(params, r["ref_grads"])
    rnew = jax.jit(lambda g, p: RQ.muon_update(
        g, RQ.muon_init(p), p, lr=jnp.float32(0.02))[0])(ref_grads, params)
    rnew = _flat(jax.tree.map(np.asarray, rnew))
    start = _flat(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    tg = {k: torch.from_numpy(v) for k, v in r["grads"].items()}
    tnew, _ = TQ.muon_update(tg, TQ.muon_init(tp), tp, lr=0.02,
                             device="cpu")
    checked = 0
    for k, p in tp.items():
        if not TQ.is_muon_param(k, p):
            continue
        mom = _tall(r["ref_grads"][k] * 1.95)      # g + 0.95 (0.95 * 0 + g)
        mine = _tall(tnew[k].numpy() - start[k])
        ref = _tall(rnew[k] - start[k])
        ctrl = _tall(_tf32(tnew[k].numpy() - start[k]))
        num = den = num_c = 0.0
        for i in np.ndindex(mom.shape[:-2]):
            c = _determined(mom[i])
            num += np.sum((mine[i][:, :c] - ref[i][:, :c]) ** 2)
            num_c += np.sum((ctrl[i][:, :c] - ref[i][:, :c]) ** 2)
            den += np.sum(ref[i][:, :c] ** 2)
        gap, control = np.sqrt(num / den), np.sqrt(num_c / den)
        assert gap <= UPDATE_RTOL, (k, gap)
        assert control > UPDATE_RTOL, ("the TF32 control passed", k, control)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_within_reference_noise(arch):
    check_gradients(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_muon_update_matches_reference(arch):
    check_first_update(arch)
