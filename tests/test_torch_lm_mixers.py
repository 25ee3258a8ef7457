"""The port's LM mixers (``repro_torch.models.{ssm, xlstm, moe,
attention}``) against the reference's on the CPU: the reference's
weights carried into the port, the same numpy-seeded inputs through
both, each mixer's forward pass with its final state and then one
decode step from that state.

Tolerance: fp32 (``cfg.scaled(dtype="float32")``), every output and
state leaf within 1e-5 of the reference's largest magnitude — fp32
rounding of the same formulas summed in different orders (the mamba
scan combines its pairs in another order than ``lax.associative_scan``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as RA, moe as RMOE, ssm as RS, xlstm as RX
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.models import attention as TA, moe as TMOE, ssm as TS
from repro_torch.models import xlstm as TX
from repro_torch.models.transformer import map_tree
from worker_threads import share_the_cores  # noqa: F401  (autouse)

TOL = 1e-5


def _pair(arch, **kw):
    kw.setdefault("dtype", "float32")
    return ref_smoke(arch).scaled(**kw), get_smoke_config(arch).scaled(**kw)


def _torch(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _ref_params(init, cfg, seed=0):
    params = init(jax.random.PRNGKey(seed), cfg)
    return params, _torch(jax.tree.map(np.asarray, params))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _close_tree(mine, ref, tol=TOL):
    ref = jax.tree.map(np.asarray, ref)
    assert set(mine) == set(ref)
    for k in ref:
        assert _rel(mine[k].numpy(), ref[k]) <= tol, (k, _rel(mine[k].numpy(),
                                                            ref[k]))


# (arch, reference module, port module, mixer name)
MIXERS = [("jamba-v0.1-52b", RS, TS, "mamba"),
          ("xlstm-1.3b", RX, TX, "mlstm"),
          ("xlstm-1.3b", RX, TX, "slstm")]


@pytest.mark.parametrize("arch,rmod,tmod,name", MIXERS,
                         ids=[m[3] for m in MIXERS])
def test_mixer_forward_state_and_decode_match_reference(arch, rmod, tmod,
                                                        name):
    """A 48-token prompt over two scan chunks, its final state, then
    two decode steps; fp32, 1e-5 relative."""
    rc, tc = _pair(arch, seq_chunk=16)
    rp, tp = _ref_params(getattr(rmod, f"{name}_init"), rc)
    x = _x((2, 50, rc.d_model))
    rfwd, rdec = getattr(rmod, f"{name}_forward"), getattr(rmod, f"{name}_decode")
    tfwd, tdec = getattr(tmod, f"{name}_forward"), getattr(tmod, f"{name}_decode")
    ry, rstate = rfwd(rp, jnp.asarray(x[:, :48]), rc, return_state=True)
    with torch.no_grad():
        ty, tstate = tfwd(tp, torch.from_numpy(x[:, :48]), tc,
                          return_state=True)
        assert _rel(ty.numpy(), ry) <= TOL
        _close_tree(tstate, rstate)
        # the whole sequence without state is the same function
        assert _rel(tfwd(tp, torch.from_numpy(x[:, :48]), tc).numpy(),
                    ry) <= TOL
        for t in (48, 49):
            ry, rstate = rdec(rp, jnp.asarray(x[:, t:t + 1]), rc, rstate)
            before = {k: v.clone() for k, v in tstate.items()}
            ty, tstate_new = tdec(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                  tstate)
            assert all(torch.equal(before[k], tstate[k]) for k in before)
            tstate = tstate_new
            assert _rel(ty.numpy(), ry) <= TOL
            _close_tree(tstate, rstate)


@pytest.mark.parametrize("name,mod,rmod", [
    ("mamba", TS, RS), ("mlstm", TX, RX), ("slstm", TX, RX)])
def test_init_state_matches_reference(name, mod, rmod):
    arch = "jamba-v0.1-52b" if name == "mamba" else "xlstm-1.3b"
    rc, tc = _pair(arch)
    ref = jax.tree.map(np.asarray, getattr(rmod, f"{name}_init_state")(rc, 3))
    mine = getattr(mod, f"{name}_init_state")(tc, 3, device="cpu")
    assert set(mine) == set(ref)
    for k in ref:
        assert mine[k].dtype == torch.float32
        assert np.array_equal(mine[k].numpy(), ref[k]), k


def test_mamba_scan_matches_a_sequential_loop():
    """The Hillis-Steele chunk scan against the recurrence stepped one
    token at a time (fp64, 1e-12)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)))
    b = torch.from_numpy(rng.standard_normal((2, 37, 3, 4)))
    h, want = torch.zeros(2, 3, 4, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = TS._scan_pairs(a, b)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    ref = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    mine = TS.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b))
    assert _rel(mine.numpy(), ref) <= TOL


def test_slstm_gate_layout_is_the_references():
    """The reference flattens the (B, H, 4 dh) recurrent product to
    (B, 4 d) and splits four equal chunks, so the i-gate of every unit
    reads head 0's recurrent block alone (ROADMAP C, "Recorded"); the
    port keeps that layout.  Changing h_{t-1} in head 1 leaves every
    unit's i-gate as it was in both packages (a per-head layout would
    move head 1's), and the port's gates equal the reference's."""
    rc, tc = _pair("xlstm-1.3b")
    rp, tp = _ref_params(RX.slstm_init, rc)
    d, heads = rc.d_model, rc.n_heads
    dh = d // heads
    assert heads == 2
    h_prev = _x((2, d), seed=3)
    h_pert = h_prev.copy()
    h_pert[:, dh:] += 1.0                       # head 1 only
    zeros = np.zeros((2, d), np.float32)
    wx = np.zeros((2, 2 * d), np.float32)
    m0 = np.full((2, d), -1e30, np.float32)

    def i_gates(h):
        # with m = -1e30, m_new = max(f + m, i) is the i-gate input
        (_, _, rm, _), _ = RX._slstm_step(
            (zeros, zeros, m0, jnp.asarray(h)), (wx, wx), r=rp["r"],
            h_heads=heads, dh=dh)
        state = [torch.from_numpy(a) for a in (zeros, zeros, m0, h)]
        (_, _, m, _), _ = TX._slstm_step(state, torch.from_numpy(wx),
                                         torch.from_numpy(wx), tp["r"],
                                         heads, dh)
        return np.asarray(rm), m.numpy()

    (ref_a, mine_a), (ref_b, mine_b) = i_gates(h_prev), i_gates(h_pert)
    np.testing.assert_array_equal(ref_a, ref_b)
    np.testing.assert_array_equal(mine_a, mine_b)
    assert _rel(mine_a, ref_a) <= TOL
    per_head = np.einsum("bd,de->be", h_prev[:, dh:],
                         np.asarray(rp["r"])[1][:, :dh])
    assert np.abs(per_head).max() > 0           # a per-head i-gate would move


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-moe-a2.7b",
                                  "phi3.5-moe-42b-a6.6b"])
@pytest.mark.parametrize("capacity", [1.25, 0.25])
def test_moe_forward_matches_reference(arch, capacity):
    """Routing, capacity slots (0.25 drops most choices), shared
    experts and the aux loss; fp32, 1e-5 relative."""
    import dataclasses

    rc, tc = _pair(arch)
    rc = rc.scaled(moe=dataclasses.replace(rc.moe, capacity_factor=capacity))
    tc = tc.scaled(moe=dataclasses.replace(tc.moe, capacity_factor=capacity))
    rp, tp = _ref_params(RMOE.moe_init, rc, seed=1)
    x = _x((2, 64, rc.d_model), seed=1)
    ry, raux = RMOE.moe_forward(rp, jnp.asarray(x), rc)
    with torch.no_grad():
        ty, taux = TMOE.moe_forward(tp, torch.from_numpy(x), tc)
    assert _rel(ty.numpy(), ry) <= TOL
    assert abs(float(taux) - float(raux)) <= TOL * abs(float(raux))
    cap = TMOE._capacity(128, tc.moe)
    assert cap == RMOE._capacity(128, rc.moe)
    if capacity < 1:
        assert cap * tc.moe.num_experts < 128 * tc.moe.top_k   # drops


def test_moe_chunked_dispatch_matches_reference(monkeypatch):
    """Both modules' token chunk set to 32: 128 tokens dispatch as four
    chunks with their own capacity, and the aux loss is their mean."""
    monkeypatch.setattr(RMOE, "_MOE_CHUNK_TOKENS", 32)
    monkeypatch.setattr(TMOE, "_MOE_CHUNK_TOKENS", 32)
    rc, tc = _pair("qwen2-moe-a2.7b")
    rp, tp = _ref_params(RMOE.moe_init, rc, seed=2)
    x = _x((2, 64, rc.d_model), seed=2)
    ry, raux = RMOE.moe_forward(rp, jnp.asarray(x), rc)
    with torch.no_grad():
        ty, taux = TMOE.moe_forward(tp, torch.from_numpy(x), tc)
        _, whole_aux = TMOE._moe_tokens(
            tp, torch.from_numpy(x).reshape(1, 128, -1), tc)
    assert _rel(ty.numpy(), ry) <= TOL
    assert abs(float(taux) - float(raux)) <= TOL * abs(float(raux))
    # the mean of the chunks' losses is not one dispatch's
    assert abs(float(taux) - float(whole_aux)) > 1e-3 * float(whole_aux)


@pytest.mark.parametrize("arch,local", [("smollm-135m", False),
                                        ("gemma2-9b", True),
                                        ("chameleon-34b", False)])
def test_attn_decode_matches_reference(arch, local):
    """Prefill's roped K/V in a 40-entry cache, then three decode steps
    (GQA, a sliding window of 8 and soft-capping on gemma2, qk-norm on
    chameleon); outputs and caches within 1e-5 relative."""
    rc, tc = _pair(arch, window=8) if arch == "gemma2-9b" else _pair(arch)
    rp, tp = _ref_params(RA.attn_init, rc)
    x = _x((2, 24, rc.d_model), seed=4)
    ry, (rk, rv) = RA.attn_forward(rp, jnp.asarray(x[:, :20]), rc,
                                   local=local, return_kv=True)
    with torch.no_grad():
        ty, (tk, tv) = TA.attn_forward(tp, torch.from_numpy(x[:, :20]), tc,
                                       local=local, return_kv=True)
    assert _rel(ty.numpy(), ry) <= TOL and _rel(tk.numpy(), rk) <= TOL
    pad = ((0, 0), (0, 20), (0, 0), (0, 0))
    rk, rv = jnp.pad(rk, pad), jnp.pad(rv, pad)
    tk = torch.nn.functional.pad(tk, (0, 0, 0, 0, 0, 20))
    tv = torch.nn.functional.pad(tv, (0, 0, 0, 0, 0, 20))
    for t in range(20, 23):
        ry, (rk, rv) = RA.attn_decode(rp, jnp.asarray(x[:, t:t + 1]), rc,
                                      local=local, cache_k=rk, cache_v=rv,
                                      cur_len=t)
        with torch.no_grad():
            ty, (tk2, tv2) = TA.attn_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                            tc, local=local, cache_k=tk,
                                            cache_v=tv, cur_len=t)
        assert tk2 is tk and tv2 is tv          # written in place
        assert _rel(ty.numpy(), ry) <= TOL
        assert _rel(tk.numpy(), rk) <= TOL and _rel(tv.numpy(), rv) <= TOL


def test_attn_decode_raises_past_the_cache():
    """A deliberate difference: the reference's dynamic_update_slice
    clamps a position past S_max and overwrites the last entry; the
    port raises."""
    rc, tc = _pair("smollm-135m")
    rp, tp = _ref_params(RA.attn_init, rc)
    x = _x((1, 1, rc.d_model))
    shape = (1, 8, rc.n_kv_heads, rc.d_head)
    _, (rk, _) = RA.attn_decode(rp, jnp.asarray(x), rc, local=False,
                                cache_k=jnp.zeros(shape),
                                cache_v=jnp.zeros(shape), cur_len=8)
    assert np.abs(np.asarray(rk)[:, 7]).max() > 0      # clamped to slot 7
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    for cur in (8, 9, -1):
        with pytest.raises(IndexError, match="outside the cache"):
            TA.attn_decode(tp, torch.from_numpy(x), tc, local=False,
                           cache_k=ck, cache_v=cv, cur_len=cur)
    assert not ck.any()


def test_expert_token_and_score_constraints_pass_plain_tensors_through():
    from repro_torch.launch import mesh as TM

    xs = [torch.zeros(4, 8, 16), torch.zeros(12, 16), torch.zeros(2, 2, 2, 1, 9)]
    fns = (sharding.constrain_expert_stack, sharding.constrain_token_stack,
           sharding.constrain_decode_scores)
    for fn, x in zip(fns, xs):
        assert fn(x) is x
    with sharding.activation_policy(TM.make_rules({"data": 2, "model": 2})):
        for fn, x in zip(fns, xs):
            assert fn(x) is x
