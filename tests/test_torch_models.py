"""The port's decoder (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU: the reference's weights
carried into the port (``params_from_numpy``), the same numpy-seeded
tokens through both.

Tolerances, relative to the largest magnitude of the reference's value:

  * fp32 (``cfg.scaled(dtype="float32")``): the loss and every gradient
    leaf within 1e-5, the logits within 1e-5 — fp32 rounding of the same
    formulas summed in different orders;
  * the configs' own bf16 compute: the loss within 1e-3 and the logits
    within ``2 * eps_bf16`` (1.6e-2; measured up to 1.1 eps_bf16) — a
    bf16 rounding of a hidden state lands on either neighbour when the
    two packages sum in different orders; the gradients within 0.05 of
    their largest entry, a few bf16 roundings of products of such
    states.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS
from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.models.attention import chunked_attention as ref_attention
from repro.training.train_step import fused_lm_loss as ref_loss
from repro_torch.configs import get_smoke_config
from repro_torch.models import (ParamTree, forward_train, init_params,
                                param_count, params_from_numpy)
from repro_torch.models import transformer as TT
from repro_torch.models.attention import chunked_attention
from repro_torch.training.train_step import fused_lm_loss

DENSE = ["smollm-135m", "olmo-1b", "gemma2-9b", "chameleon-34b",
         "qwen2.5-32b", "musicgen-large"]
ALL = list(ARCHS)
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)


def _pair(arch, dtype=None):
    rc, tc = ref_smoke(arch), get_smoke_config(arch)
    if dtype is not None:
        rc, tc = rc.scaled(dtype=dtype), tc.scaled(dtype=dtype)
    return rc, tc


def _ref_params(cfg, seed=0):
    params = RT.init_params(jax.random.PRNGKey(seed), cfg)
    return params, jax.tree.map(np.asarray, params)


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
            out[name] = v
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _loss_and_grads(arch, dtype):
    rc, tc = _pair(arch, dtype)
    params, npp = _ref_params(rc)
    batch = _batch(rc)

    def ref_fn(p):
        x, aux = RT.forward_hidden(p, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, rc)
        nll, _ = ref_loss(x, RT.lm_head_weight(p, rc),
                          jnp.asarray(batch["labels"]),
                          logit_softcap=rc.logit_softcap, chunk=16)
        return nll + aux

    rloss, rgrads = jax.value_and_grad(ref_fn)(params)
    model = params_from_numpy(npp, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    x, aux = TT.forward_hidden(model, tb, tc)
    nll, _ = fused_lm_loss(x, TT.lm_head_weight(model, tc), tb["labels"],
                           logit_softcap=tc.logit_softcap, chunk=16)
    loss = nll + aux
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)))
    return (float(rloss), _flat(jax.tree.map(np.asarray, rgrads)),
            float(loss), {k: g.numpy() for k, g in grads.items()})


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_reference_fp32(arch):
    """Tolerance: 1e-5 relative (loss; each gradient leaf against its
    largest entry)."""
    rloss, rgrads, loss, grads = _loss_and_grads(arch, "float32")
    assert abs(loss - rloss) <= 1e-5 * abs(rloss)
    assert set(grads) == set(rgrads)
    for k, g in rgrads.items():
        assert _rel(grads[k], g) <= 1e-5, (k, _rel(grads[k], g))


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-9b"])
def test_loss_and_every_gradient_match_reference_bf16(arch):
    """The configs' bf16 compute: loss within 1e-3 relative, each
    gradient leaf within 0.05 of its largest entry."""
    rloss, rgrads, loss, grads = _loss_and_grads(arch, None)
    assert abs(loss - rloss) <= 1e-3 * abs(rloss)
    for k, g in rgrads.items():
        assert _rel(grads[k], g) <= 0.05, (k, _rel(grads[k], g))


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ALL]
                         + [(a, None) for a in DENSE])
def test_forward_train_logits_match_reference(arch, dtype):
    """Logits: 1e-5 relative in fp32, 2 * eps_bf16 relative in bf16; the
    MoE aux loss to the same relative tolerance (zero without MoE).  The
    recurrent and MoE architectures' bf16 run is held layer by layer
    (:func:`test_bf16_layers_match_reference_layer_by_layer`)."""
    rc, tc = _pair(arch, dtype)
    params, npp = _ref_params(rc, seed=1)
    batch = _batch(rc, seed=1)
    rlog, raux = RT.forward_train(params, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, rc)
    with torch.no_grad():
        tlog, taux = forward_train(params_from_numpy(npp, "cpu"),
                                   {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, tc)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == rlog.shape
    tol = 1e-5 if dtype == "float32" else 2 * BF16_EPS
    assert _rel(tlog.numpy(), rlog) <= tol
    assert abs(float(taux) - float(raux)) <= tol * abs(float(raux))
    assert (float(raux) == 0.0) == (rc.moe is None)


@pytest.mark.parametrize("arch", [a for a in ALL if a not in DENSE])
def test_bf16_layers_match_reference_layer_by_layer(arch):
    """bf16, each layer of the stack fed the reference's own input: the
    port's output within 2 * eps_bf16 of the reference's largest
    magnitude (measured: at most 3.0e-3, an mLSTM layer), and the MoE aux
    loss within 1e-5.  Over the whole stack the bf16 gaps compound
    instead: the logits part by up to 2.4e-2 (xlstm-1.3b, eight layers of
    one-ulp differences), and a one-ulp difference in a hidden state
    flips a near-tied top-k choice of a router (qwen2-moe 0.12, jamba
    0.60), so the whole-model bf16 logits are not compared."""
    rc, tc = _pair(arch)
    params, npp = _ref_params(rc, seed=1)
    batch = _batch(rc, seed=1)
    x = RT._embed_input(params, {k: jnp.asarray(v) for k, v in
                                 batch.items()}, rc)
    mine = params_from_numpy(npp, "cpu").tree()["layers"]
    worst = 0.0
    for i in range(rc.n_periods):
        for pi, spec in enumerate(rc.period):
            rp = jax.tree.map(lambda a: a[i], params["layers"][pi])
            tp = TT.map_tree(lambda t: t[i], mine[pi])
            want, _, raux = RT._apply_layer(rp, x, rc, spec, mode="train",
                                            cache=None, pos=None)
            with torch.no_grad():
                got, _, taux = TT._apply_layer(
                    tp, torch.from_numpy(np.array(x.astype(jnp.float32))
                                         ).to(torch.bfloat16), tc, spec)
            assert got.dtype == torch.bfloat16
            err = _rel(got.float().numpy(), want.astype(jnp.float32))
            assert err <= 2 * BF16_EPS, (i, pi, err)
            worst = max(worst, err)
            if spec.ffn == "moe":
                assert abs(float(taux) - float(raux)) <= 1e-5 * float(raux)
            x = want
    assert worst > 0.0


@pytest.mark.parametrize("window,softcap,skip", [
    (None, None, False), (24, None, False), (24, 30.0, True),
    (None, 50.0, True)])
def test_chunked_attention_matches_reference(window, softcap, skip):
    """Several query and key/value chunks, GQA groups of 2; fp32;
    tolerance 1e-5 relative."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    pos = np.arange(64)
    kw = dict(window=window, softcap=softcap, q_chunk=16, kv_chunk=32,
              causal_skip=skip)
    ref = ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.asarray(pos), **kw)
    mine = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             q_pos=torch.from_numpy(pos), **kw)
    assert _rel(mine.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_fused_lm_loss_matches_reference(softcap):
    """Four sequence chunks: mean NLL and accuracy at 1e-6 relative, the
    gradients of x and of the head at 1e-5 relative."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    lab = rng.integers(0, 40, (2, 32)).astype(np.int32)

    def ref_fn(x_, w_):
        return ref_loss(x_, w_, jnp.asarray(lab), logit_softcap=softcap,
                        chunk=8)

    rn, ra = ref_fn(jnp.asarray(x), jnp.asarray(w))
    rgx, rgw = jax.grad(lambda a, b: ref_fn(a, b)[0], (0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    n, a = fused_lm_loss(tx, tw, torch.from_numpy(lab),
                         logit_softcap=softcap, chunk=8)
    gx, gw = torch.autograd.grad(n, (tx, tw))
    assert abs(float(n) - float(rn)) <= 1e-6 * abs(float(rn))
    assert float(a) == pytest.approx(float(ra), abs=1e-7)
    assert _rel(gx.numpy(), rgx) <= 1e-5 and _rel(gw.numpy(), rgw) <= 1e-5


@pytest.mark.parametrize("arch", ALL)
def test_carry_keeps_the_reference_tree(arch):
    """The port's parameter names are the reference's paths, its values
    the reference's arrays bit for bit, and the counts agree."""
    rc, tc = _pair(arch)
    params, npp = _ref_params(rc)
    model = params_from_numpy(npp, "cpu")
    ref_flat = _flat(npp)
    mine = dict(model.named_parameters())
    assert set(mine) == set(ref_flat)
    for k, v in ref_flat.items():
        assert np.array_equal(mine[k].detach().numpy(), v)
    assert param_count(model) == RT.param_count(params)
    assert param_count(model.tree()) == RT.param_count(params)


@pytest.mark.parametrize("arch", ALL)
def test_init_params_shapes_and_scales(arch):
    """Fresh port weights have the reference's tree, shapes and dtypes
    (fp32 masters); dense weights draw at 1 / sqrt(d_in)."""
    rc, tc = _pair(arch)
    ref = _flat(jax.eval_shape(lambda: RT.init_params(
        jax.random.PRNGKey(0), rc)))
    model = init_params(torch.Generator().manual_seed(0), tc)
    mine = {k: p for k, p in model.named_parameters()}
    assert {k: tuple(v.shape) for k, v in ref.items()} == \
        {k: tuple(p.shape) for k, p in mine.items()}
    assert all(p.dtype == torch.float32 for p in mine.values())
    first = {"attn": "wq", "attn_local": "wq", "mamba": "in_proj",
             "mlstm": "up", "slstm": "w_if"}[tc.period[0].mixer]
    w = mine[f"layers.0.mixer.{first}.w"]
    assert float(w.std()) == pytest.approx(tc.d_model ** -0.5, rel=0.15)
    assert isinstance(model, ParamTree)


def test_stacked_gradient_is_one_leaf_per_period_position():
    """Autograd fills each stacked leaf's gradient for every period: no
    period's slice of a used weight is left zero."""
    cfg = get_smoke_config("smollm-135m").scaled(dtype="float32")
    model = init_params(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    x, _ = TT.forward_hidden(model, batch, cfg)
    loss, _ = fused_lm_loss(x, TT.lm_head_weight(model, cfg),
                            batch["labels"], logit_softcap=None)
    wq = dict(model.named_parameters())["layers.0.mixer.wq.w"]
    g = torch.autograd.grad(loss, wq)[0]
    assert g.shape[0] == cfg.n_periods
    assert all(g[i].abs().sum() > 0 for i in range(cfg.n_periods))
