"""The port's LM serving path on the CPU: twins of the reference's
``tests/test_models_smoke.py`` for all ten smoke configs (forward and one
gradient step, a decode step, train / prefill / decode consistency,
causality, the full configs' parameter classes), ``forward_prefill`` and
``forward_decode`` against the reference's step by step, and
``ServeEngine`` / ``launch.serve``.

Tolerances: the twins keep the reference's own (2e-4 absolute for the
consistency, 1e-5 for causality); against the reference, fp32 logits and
every cache leaf within 1e-5 of the reference's largest magnitude, and
greedy tokens equal.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models import transformer as RT
from repro.serving import ServeEngine as RefEngine
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import roofline
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (active_param_count, forward_decode,
                                forward_prefill, forward_train, init_caches,
                                init_params, param_count, params_from_numpy)
from repro_torch.models.layers import embed
from repro_torch.serving import ServeEngine

TOL = 1e-5


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tokens(cfg, b, s, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int64))


def _inputs(cfg, params, toks, dtype=torch.bfloat16):
    if cfg.embedding_input:
        return {"embeds": embed(params.tree()["embed"], toks, dtype=dtype)}
    return {"tokens": toks}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ----------------------------------------------------- twins of the smoke tests

@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    """Forward and one gradient step: shapes, finite values, a nonzero
    gradient (the MoE aux loss in the loss)."""
    cfg = get_smoke_config(arch)
    b, s = 2, 64
    params = init_params(_gen(), cfg)
    toks, labels = _tokens(cfg, b, s), _tokens(cfg, b, s, seed=1)
    logits, aux = forward_train(params, _inputs(cfg, params, toks), cfg)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -lp.gather(-1, labels[..., None]).mean() + aux
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_step(arch):
    cfg = get_smoke_config(arch)
    b, s_max = 2, 64
    params = init_params(_gen(), cfg)
    caches = init_caches(cfg, b, s_max, device="cpu")
    with torch.inference_mode():
        logits, new = forward_decode(params, torch.zeros((b, 1), dtype=torch.int64),
                                     cfg, caches, 3)
    assert logits.shape == (b, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert len(new) == len(caches)
    for old, nw in zip(caches, new):
        assert set(old) == set(nw)
        assert all(old[k].shape == nw[k].shape and old[k].dtype == nw[k].dtype
                   for k in old)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_prefill_decode_consistency(arch):
    """Teacher-forced forward == prefill + step-by-step decode (fp32,
    capacity-unconstrained MoE; the reference's 2e-4)."""
    b, s, s0 = 1, 32, 24
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = init_params(_gen(), cfg)
    toks = _tokens(cfg, b, s)
    with torch.inference_mode():
        full = _inputs(cfg, params, toks, torch.float32)
        pre = {k: v[:, :s0] for k, v in full.items()}
        full_logits, _ = forward_train(params, full, cfg)
        plog, caches = forward_prefill(params, pre, cfg)
        np.testing.assert_allclose(plog[:, -1].numpy(),
                                   full_logits[:, s0 - 1].numpy(), atol=2e-4)
        cur = tuple({k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - s0))
                     for k, v in e.items()} if "k" in e else e
                    for e in caches)
        for t in range(s0, s):
            dlog, cur = forward_decode(params, toks[:, t:t + 1], cfg, cur, t)
            np.testing.assert_allclose(dlog[:, 0].numpy(),
                                       full_logits[:, t].numpy(), atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_causality(arch):
    """Perturbing a future token never changes past logits."""
    cfg = get_smoke_config(arch).scaled(dtype="float32")
    params = init_params(_gen(), cfg)
    toks = _tokens(cfg, 1, 32)
    toks2 = toks.clone()
    toks2[0, 20] = (toks[0, 20] + 7) % cfg.vocab_size
    with torch.no_grad():
        a, _ = forward_train(params, _inputs(cfg, params, toks, torch.float32),
                             cfg)
        c, _ = forward_train(params, _inputs(cfg, params, toks2, torch.float32),
                             cfg)
    np.testing.assert_allclose(a[:, :16].numpy(), c[:, :16].numpy(), atol=1e-5)
    assert not torch.equal(a[:, 20:], c[:, 20:])


def test_param_counts_full_configs_in_class():
    """Full configs on the meta device land in the advertised parameter
    class; MoE's active count is below its total."""
    expected_range = {
        "olmo-1b": (0.9e9, 1.6e9),
        "smollm-135m": (0.10e9, 0.17e9),
        "qwen2.5-32b": (28e9, 36e9),
        "gemma2-9b": (8e9, 11e9),
        "jamba-v0.1-52b": (45e9, 58e9),
        "phi3.5-moe-42b-a6.6b": (38e9, 45e9),
        "chameleon-34b": (30e9, 38e9),
        "musicgen-large": (1.5e9, 2.6e9),
        "qwen2-moe-a2.7b": (12e9, 16e9),
        "xlstm-1.3b": (1.0e9, 2.4e9),
    }
    for arch, (lo, hi) in expected_range.items():
        cfg = get_config(arch)
        params = roofline._meta_params(cfg)
        assert all(p.device.type == "meta" for p in params.parameters())
        n = param_count(params)
        assert lo <= n <= hi, (arch, n)
        assert (active_param_count(params, cfg) < n) == (cfg.moe is not None)
    assert param_count(roofline._meta_params(get_config("xlstm-1.3b"))) == \
        1_943_646_544


# ------------------------------------------------------ against the reference

def _ref_pair(arch, **kw):
    kw.setdefault("dtype", "float32")
    return ref_smoke(arch).scaled(**kw), get_smoke_config(arch).scaled(**kw)


def _cache_rel(mine, ref):
    ref = jax.tree.map(np.asarray, ref)
    assert len(mine) == len(ref)
    for m, r in zip(mine, ref):
        assert set(m) == set(r)
        for k in r:
            assert _rel(m[k].float().numpy(), r[k].astype(np.float32)) <= TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_step_by_step(arch):
    """fp32: prefill's last logits and caches, then three decode steps'
    logits and caches (attention caches padded to 28 entries)."""
    rc, tc = _ref_pair(arch)
    params = RT.init_params(jax.random.PRNGKey(1), rc)
    model = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(1).integers(0, rc.vocab_size, (2, 24))
    if rc.embedding_input:
        emb = np.array(RT.embed(params["embed"], jnp.asarray(toks),
                                dtype=jnp.float32))
        rb, tb = {"embeds": jnp.asarray(emb[:, :20])}, {
            "embeds": torch.from_numpy(emb[:, :20])}
    else:
        rb, tb = {"tokens": jnp.asarray(toks[:, :20])}, {
            "tokens": torch.from_numpy(toks[:, :20])}
    rlog, rcache = jax.jit(lambda p, b: RT.forward_prefill(p, b, rc))(params, rb)
    with torch.inference_mode():
        tlog, tcache = forward_prefill(model, tb, tc)
    assert tlog.shape == rlog.shape and _rel(tlog.numpy(), rlog) <= TOL
    _cache_rel(tcache, rcache)

    def pad_ref(e):
        if "k" not in e:
            return e
        return {k: jnp.pad(v, ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0)))
                for k, v in e.items()}

    rcache = tuple(pad_ref(e) for e in rcache)
    tcache = tuple({k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8))
                    for k, v in e.items()} if "k" in e else e
                   for e in tcache)
    step = jax.jit(lambda p, t, c, pos: RT.forward_decode(p, t, rc, c, pos))
    for t in range(20, 23):
        rlog, rcache = step(params, jnp.asarray(toks[:, t:t + 1]), rcache,
                            jnp.int32(t))
        with torch.inference_mode():
            tlog, tcache = forward_decode(model, torch.from_numpy(
                toks[:, t:t + 1]), tc, tcache, t)
        assert _rel(tlog.numpy(), rlog) <= TOL
        _cache_rel(tcache, rcache)


@pytest.mark.parametrize("arch", ["gemma2-9b", "xlstm-1.3b",
                                  "jamba-v0.1-52b"])
def test_serve_engine_greedy_tokens_equal_reference(arch):
    """fp32 configs, batch 3, a 16-token prompt and 10 new tokens: the
    port's greedy tokens are the reference engine's."""
    rc, tc = _ref_pair(arch)
    params = RT.init_params(jax.random.PRNGKey(0), rc)
    model = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    prompts = np.random.default_rng(2).integers(0, rc.vocab_size, (3, 16))
    ref = RefEngine(params, rc, batch=3, max_len=32).generate(
        jnp.asarray(prompts), 10)
    mine = ServeEngine(model, tc, batch=3, max_len=32, device="cpu").generate(
        prompts, 10)
    assert mine.dtype == torch.int32 and tuple(mine.shape) == (3, 10)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_generates_for_every_arch(arch):
    """Each smoke config (bf16) serves 2 prompts of 8 for 4 new tokens;
    the embedding-input architecture takes its prompts as embeddings."""
    cfg = get_smoke_config(arch)
    params = init_params(_gen(), cfg)
    prompts = _tokens(cfg, 2, 8)
    embeds = (_inputs(cfg, params, prompts)["embeds"] if cfg.embedding_input
              else None)
    out = ServeEngine(params, cfg, batch=2, max_len=16, device="cpu").generate(
        prompts, 4, prompt_embeds=embeds)
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_serving_greedy_reproducible_and_batched():
    """Twin of the reference's test: two greedy runs agree, and request
    0's tokens do not depend on request 2's prompt."""
    cfg = get_smoke_config("gemma2-9b")
    eng = ServeEngine(init_params(_gen(), cfg), cfg, batch=3, max_len=64,
                      device="cpu")
    prompts = _tokens(cfg, 3, 16)
    a = eng.generate(prompts, 8)
    b = eng.generate(prompts, 8)
    assert torch.equal(a, b) and a.shape == (3, 8)
    prompts2 = prompts.clone()
    prompts2[2] = (prompts[2] + 1) % cfg.vocab_size
    c = eng.generate(prompts2, 8)
    assert torch.equal(a[0], c[0])


def test_temperature_sampling_is_reproducible_from_its_seed():
    """The engine's torch.Generator stream (not JAX's): the same seed
    gives the same tokens, another seed other tokens."""
    cfg = get_smoke_config("smollm-135m")
    params = init_params(_gen(), cfg)
    prompts = _tokens(cfg, 2, 8)

    def run(seed):
        return ServeEngine(params, cfg, batch=2, max_len=32, temperature=50.0,
                           seed=seed, device="cpu").generate(prompts, 12)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_engine_runs_where_its_parameters_are():
    cfg = get_smoke_config("smollm-135m")
    with pytest.raises(ValueError, match="move them first"):
        ServeEngine(roofline._meta_params(cfg), cfg, batch=1, max_len=8,
                    device="cpu")
    params = init_params(_gen(), cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(params, cfg, batch=1, max_len=8)
    eng = ServeEngine(params, cfg, batch=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        eng.generate(_tokens(cfg, 1, 4), 5)


def test_launch_serve_smoke_on_the_cpu(capsys):
    row = launch_serve.main(["--arch", "xlstm-1.3b", "--smoke", "--device",
                             "cpu", "--prompt-len", "8", "--steps", "6"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == row
    assert line["arch"] == "xlstm-1.3b" and line["steps"] == 6
    assert len(line["sample"]) == 6 and line["tokens_per_s"] > 0


def test_chip_smoke_phase_18_rehearses_on_the_cpu(monkeypatch, capsys):
    """``chip_smoke.py``'s phase 18 at the smoke configs on the CPU, an
    8-token prompt and 4 new tokens, (c) on 8 + 4 tokens: the launcher,
    the greedy and independence gates, and (c)'s consistency gate with
    its bf16 control failing it."""
    monkeypatch.syspath_prepend(str(pathlib.Path(__file__).parents[1]))
    import chip_smoke

    for name, value in (("SERVE_PROMPT", 8), ("SERVE_STEPS", 4),
                        ("CONSIST_PREFILL", 8), ("CONSIST_DECODE", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_lm_serving(torch, device="cpu", smoke=True)
    assert set(out["models"]) == {"xlstm-1.3b", "smollm-135m",
                                  "jamba-v0.1-52b"}
    for m in out["models"].values():
        assert m["consistency_rel"] <= m["consistency_tol"] < \
            m["bf16_control_rel"]
        assert m["peak_gb"] is None and "decode_trace" not in m
    assert out["models"]["jamba-v0.1-52b"]["reduced"].startswith(
        "n_layers 32 -> 8")
    assert out["launcher"]["steps"] == 4
