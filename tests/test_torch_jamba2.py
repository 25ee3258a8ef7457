"""jamba2-mini (AI21-Jamba2-Mini) on the port's normal path, held to the
benchmark's plain reference (``perfbench/reference/jamba.py``) on the
CPU at the configuration file's smoke sizes, in float32, from one seeded
draw of the reference's parameter tree.

* the full forward's logits, and prefill followed by cached decode
  against the full forward pass;
* each of the configuration's switches turned back (RoPE on, no inner
  norms, renormalized top-k, capacity dispatch at a batch where capacity
  drops tokens) fails the same comparison;
* the dropless route computes every routed pair: a batch routed to two
  experts, where capacity 1.25 drops pairs, equals the reference, and a
  token's output does not depend on the tokens batched with it;
* qwen2-moe's capacity route gives the same bits as before the dropless
  route and the switches were added (a frozen copy of it below);
* the registry, the serving engine and ``launch.serve`` find and run
  the configuration.

Tolerance: logits within 1e-5 of the reference's largest magnitude (the
port's serving tests use the same); the float32 readings are ~1e-6, and a
switch turned back reads 1e-2 or more.
"""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import bench  # noqa: E402
from perfbench.reference import inputs, jamba  # noqa: E402
from perfbench.reference.model import leaves, map_tree  # noqa: E402
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import (ParamTree, forward_decode, forward_prefill,  # noqa: E402
                                forward_train, init_params)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import dense, ffn, gelu_tanh, silu  # noqa: E402
from repro_torch.observability import metrics  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from worker_threads import share_the_cores  # noqa: F401,E402  (autouse)

TOL = 1e-5
CELL = "jamba2-mini.decode-b64-p1024"
SEED = 2147483917


def _setup(**switches):
    """(program config in fp32 with ``switches``, reference config,
    weights tree) at the configuration file's smoke sizes."""
    cell = bench.Cell(CELL, seed=SEED, seconds=0, trace=False, device="cpu", smoke=True)
    cfg = dataclasses.replace(cell.port_config(), dtype="float32", **switches)
    ref_cfg = cell.ref_config()
    return cfg, ref_cfg, inputs.weights(jamba.param_spec(ref_cfg), SEED, "cpu")


def _tokens(cfg, b, s, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _ref_logits(tree, toks, ref_cfg):
    with torch.no_grad():
        return jamba.logits(tree, toks, ref_cfg)


def test_registry_keeps_the_twins_apart():
    """jamba2-mini is found by id but is not among the ids the tests hold
    against the reference's registry; the published widths."""
    assert "jamba2-mini" in PORT_ARCHS and "jamba2-mini" not in ARCHS
    cfg = get_config("jamba2-mini")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            cfg.d_ff, cfg.vocab_size) == (32, 4096, 32, 8, 128, 14336, 65536)
    assert (cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.conv_kernel) == (8192, 16, 256, 4)
    assert cfg.moe.num_experts == 16 and cfg.moe.top_k == 2 and cfg.moe.d_expert == 14336
    assert cfg.moe.capacity_factor is None and not cfg.moe.normalize_topk
    assert cfg.rope_theta is None and cfg.mamba_inner_norm and not cfg.tie_embeddings
    assert [(s.mixer, s.ffn) for s in cfg.period] == [
        ("attn" if i == 4 else "mamba", "moe" if i % 2 else "dense") for i in range(8)]
    jamba_v01 = get_config("jamba-v0.1-52b")
    assert jamba_v01.rope_theta == 10_000.0 and not jamba_v01.mamba_inner_norm
    assert jamba_v01.moe.capacity_factor == 1.25 and jamba_v01.moe.normalize_topk
    with pytest.raises(KeyError):
        get_config("jamba2-max")


def test_param_tree_matches_reference():
    """The reference's spec has the program's leaf names and shapes."""
    cfg, ref_cfg, _ = _setup()
    port = init_params(torch.Generator().manual_seed(0), cfg)
    want = {k: tuple(p.shape) for k, p in port.named_parameters()}
    got = {k: i.shape for k, i in leaves(jamba.param_spec(ref_cfg))}
    assert got == want
    assert any(k.endswith("mixer.dt_norm.g") for k in want)


def test_forward_logits_match_reference():
    cfg, ref_cfg, tree = _setup()
    toks = _tokens(cfg, 3, 40)
    with torch.no_grad():
        got, _ = forward_train(ParamTree(tree), {"tokens": toks}, cfg)
    assert _rel(got, _ref_logits(tree, toks, ref_cfg)) < TOL


def test_prefill_then_cached_decode_match_the_full_forward(monkeypatch):
    """Prefill of 24 tokens then 8 cached decode steps, each step's
    logits against the full forward pass at its position; through
    ``ServeEngine`` with the prefill in row groups too."""
    cfg, ref_cfg, tree = _setup()
    toks = _tokens(cfg, 3, 32, seed=1)
    ref = _ref_logits(tree, toks, ref_cfg)
    params = ParamTree(tree)
    with torch.no_grad():
        logits, caches = forward_prefill(params, {"tokens": toks[:, :24]}, cfg)
        got = [logits]
        caches = ServeEngine(params, cfg, batch=3, max_len=32, device="cpu")._pad_caches(caches)
        for pos in range(24, 31):
            logits, caches = forward_decode(params, toks[:, pos:pos + 1], cfg, caches, pos)
            got.append(logits)
    assert _rel(torch.cat(got, 1), ref[:, 23:31]) < TOL

    monkeypatch.setattr(engine_mod, "PREFILL_TOKENS", 24)     # one row a group
    eng = ServeEngine(params, cfg, batch=3, max_len=32, device="cpu")
    logits, caches = eng.prefill(toks[:, :24])
    got = [logits]
    for pos in range(24, 31):
        logits, caches = eng.decode(toks[:, pos:pos + 1], caches, pos)
        got.append(logits)
    assert _rel(torch.cat(got, 1), ref[:, 23:31]) < TOL


def _skewed_tokens(cfg, b, s):
    """A batch whose tokens the first MoE layer routes to the same two
    experts: every position holds the same id."""
    return torch.full((b, s), 7, dtype=torch.int64)


@pytest.mark.parametrize("switch", ["rope", "no_inner_norm", "renormalized", "capacity"])
def test_each_switch_turned_back_fails_the_comparison(switch):
    base, _, _ = _setup()
    over = {"rope": {"rope_theta": 10_000.0},
            "no_inner_norm": {"mamba_inner_norm": False},
            "renormalized": {"moe": dataclasses.replace(base.moe, normalize_topk=True)},
            "capacity": {"moe": dataclasses.replace(base.moe, capacity_factor=1.25)}}[switch]
    cfg, ref_cfg, tree = _setup(**over)
    toks = _skewed_tokens(cfg, 2, 64) if switch == "capacity" else _tokens(cfg, 3, 40)
    ref = _ref_logits(tree, toks, ref_cfg)
    with torch.no_grad():
        sound, _ = forward_train(ParamTree(tree), {"tokens": toks}, base)
        got, _ = forward_train(ParamTree(tree), {"tokens": toks}, cfg)
    assert _rel(sound, ref) < TOL
    assert _rel(got, ref) > 1e3 * TOL


def _first_period(layer):
    return map_tree(lambda t: t[0], layer)


def _moe_layer(tree):
    """The first MoE layer's weights (period position 1, period 0)."""
    return _first_period(tree["layers"][1]["moe"])


def test_dropless_drops_nothing_where_capacity_would():
    """64 tokens near one point, so two experts take every pair: capacity
    1.25 keeps 40 of each expert's 64 pairs; the dropless route computes
    them all (it equals the reference), the capacity route does not, and
    a token's dropless output is the same alone or in the batch."""
    cfg, ref_cfg, tree = _setup()
    p = _moe_layer(tree)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 1, cfg.d_model, generator=gen) \
        + 1e-3 * torch.randn(1, 64, cfg.d_model, generator=gen)
    probs = torch.softmax(x[0] @ p["router"]["w"], -1)
    experts = torch.topk(probs, 2, -1).indices
    assert len(torch.unique(experts)) == 2
    cap = moe_mod._capacity(64, dataclasses.replace(cfg.moe, capacity_factor=1.25))
    assert cap == 40 < 64
    with torch.no_grad():
        want = jamba.moe(p, x, ref_cfg)
        y, _ = moe_mod.moe_forward(p, x, cfg)
        capped = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
        y_cap, _ = moe_mod.moe_forward(p, x, capped)
        alone, _ = moe_mod.moe_forward(p, x[:, -3:], cfg)
    assert _rel(y, want) < TOL
    assert _rel(y_cap, want) > 0.1
    torch.testing.assert_close(alone, y[:, -3:], rtol=1e-6, atol=1e-6)


def test_logits_do_not_depend_on_the_co_batched_rows():
    """A row's logits alone and among three other rows, skewed so that
    capacity would drop pairs: the same within the float32 tolerance."""
    cfg, _, tree = _setup()
    toks = torch.cat([_tokens(cfg, 1, 48, seed=4), _skewed_tokens(cfg, 3, 48)])
    with torch.no_grad():
        alone, _ = forward_train(ParamTree(tree), {"tokens": toks[:1]}, cfg)
        batched, _ = forward_train(ParamTree(tree), {"tokens": toks}, cfg)
    assert _rel(batched[:1], alone) < TOL


def test_moe_pairs_counter_counts_the_routed_pairs():
    cfg, _, tree = _setup()
    p = _moe_layer(tree)
    before = metrics.REGISTRY.counter_total("models.moe_pairs", route="dropless")
    with torch.no_grad():
        moe_mod.moe_forward(p, torch.randn(2, 5, cfg.d_model), cfg)
    after = metrics.REGISTRY.counter_total("models.moe_pairs", route="dropless")
    assert after - before == 2 * 5 * cfg.moe.top_k


def _capacity_before(p, x, cfg):
    """The capacity dispatch of a (1, T, d) block as it was before the
    dropless route was added (frozen copy)."""
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    c = math.ceil(t * moe.top_k / moe.num_experts * moe.capacity_factor)
    cap = max(8, min(t, (c + 7) // 8 * 8))
    xt = x.reshape(t, d)
    probs = torch.softmax(xt.to(torch.float32) @ p["router"]["w"], dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    flat_idx = expert_idx.reshape(-1)
    onehot = F.one_hot(flat_idx, e)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=-1) - 1
    keep = (pos >= 0) & (pos < cap)
    pos_c = torch.clamp(pos, 0, cap - 1)
    x_rep = torch.where(keep[:, None], torch.repeat_interleave(xt, k, dim=0), 0)
    buf = torch.zeros((e, cap, d), dtype=x.dtype).index_put_((flat_idx, pos_c), x_rep,
                                                             accumulate=True)
    bw = x.dtype
    up = torch.bmm(buf, p["up_w"].to(bw))
    act = silu if cfg.ffn_act == "swiglu" else gelu_tanh
    h = act(torch.bmm(buf, p["gate_w"].to(bw))) * up
    out_buf = torch.bmm(h, p["down_w"].to(bw))
    gathered = out_buf[flat_idx, pos_c]
    w = (gate_vals.reshape(-1) * keep).to(gathered.dtype)
    y = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    if moe.num_shared > 0:
        sg = torch.sigmoid(dense(p["shared_gate"], x, dtype=torch.float32))
        y = y.reshape(b, s, d) + (sg * ffn(p["shared"], x, cfg.ffn_act
                                           ).to(torch.float32)).to(y.dtype)
        y = y.reshape(t, d)
    f_e = F.one_hot(expert_idx, e).to(torch.float32).mean(dim=(0, 1)) * k
    aux = moe.router_aux_weight * e * torch.sum(f_e * probs.mean(dim=0))
    return y.reshape(b, s, d).to(x.dtype), aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qwen2_moe_capacity_route_keeps_its_bits(dtype):
    """qwen2-moe's MoE layer (60 experts at smoke size 6, top-4, shared
    experts, capacity 1.25) gives the same bits and aux loss as the
    capacity route before the change, at a batch where it drops pairs."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    p = _first_period(init_params(torch.Generator().manual_seed(5), cfg).tree()["layers"][0]["moe"])
    x = (torch.randn(1, 1, cfg.d_model) + 0.05 * torch.randn(1, 96, cfg.d_model)).to(dtype)
    with torch.no_grad():
        y, aux = moe_mod.moe_forward(p, x, cfg)
        y0, aux0 = _capacity_before(p, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_serve_engine_and_launcher_run_jamba2():
    """``ServeEngine`` serves the smoke config greedily, the same tokens
    twice (row groups: ``tests/test_torch_lm_serving.py``); ``launch.serve
    --arch jamba2-mini --smoke`` runs."""
    cfg = get_smoke_config("jamba2-mini")
    params = init_params(torch.Generator().manual_seed(6), cfg)
    prompt = _tokens(cfg, 4, 16, seed=6)
    first, again = (ServeEngine(params, cfg, batch=4, max_len=32, device="cpu").generate(prompt, 8)
                    for _ in range(2))
    assert torch.equal(first, again) and tuple(first.shape) == (4, 8)
    row = launch_serve.main(["--arch", "jamba2-mini", "--smoke", "--batch", "2",
                             "--prompt-len", "8", "--steps", "4", "--device", "cpu"])
    assert row["arch"] == "jamba2-mini" and len(row["sample"]) == 4
