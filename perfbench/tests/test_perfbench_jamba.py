"""The ``jamba2-mini.decode-b64-p1024`` cell's harness files on the CPU:
its kind (``traffic/decode_hybrid.py``) runs the cell end to end at the
configuration's smoke sizes; the control (the reference with float8
products) and the cache faults fail the cell's limits where the program
and the bf16 witnesses pass them; ``counts/jamba.py`` against a hand count; and the
readers of the MoE and Mamba layers' device time on synthetic traces."""

import pytest

from perfbench import bench
from perfbench.counts import jamba as counts
from perfbench.reference import compare
from perfbench.trace import Trace

CELL = "jamba2-mini.decode-b64-p1024"
PB = bench.ROOT / "perfbench"
OFFSET = 7_000_000_000          # perf_counter ns -> the trace's clock


def _cell(trace=False, **traffic):
    cell = bench.Cell(CELL, seed=2147483921, seconds=1, trace=trace, device="cpu", smoke=True)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_the_kind_runs_the_cell(trace):
    cell = _cell(trace, batch=8, prompt=48, max_steps=40, sample_rows=4, trace_steps=3)
    out = bench.run(cell)
    line = bench.result_line(cell, out)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"mean_gap", "logit_gap"}
    assert line["attempted"] > 0 and line["attempted"] % 8 == 0
    if trace:
        ctx = out["ctx"]
        assert ctx["moe_pairs"] == 8 * 2 * 4          # batch x top-2 x 4 MoE layers
        assert ctx["moe_roofline_s"] == counts.moe_step(cell.ref_config(), 8)["roofline_s"]
        names = {n for n, _, _ in ctx["spans"]}
        assert {"models.moe", "models.mamba", "serve.sample"} <= names
        assert {"mfu.decode", "decode_host_ms.decode"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"decode_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [2147483001, 2147483002, 2147483003])
def test_control_and_stale_state_fail_the_limits(seed):
    """The program and both bf16 witnesses pass the cell's comparison; the
    float8 control fails it on both readings, the cache faults on
    ``logit_gap``."""
    cell = _cell(batch=8, prompt=64, sample_rows=4)
    res = dict(cell.kind.calibrate_seed(cell, seed, control=True, steps=40))
    limits = cell.limits
    for what in ("program", "witness_bf16", "witness_bf16_residual"):
        assert compare.check(res[what], limits)[0], (what, res)
    _, rows = compare.check(res["control"], limits)
    assert all(v > lim for _, v, lim in rows), res
    for fault in ("stale_state", "stale_conv"):
        assert set(res[fault]) == {"logit_gap", "logit_gap_max"}
        assert res[fault]["logit_gap"] > limits["logit_gap"], res


def test_counts_match_a_hand_count():
    """The smoke shape: d 64, 4 heads (2 K/V) of 16, d_ff 128, V 256;
    Mamba inner 128, state 4, dt_rank 8, conv 4; 4 experts of 64, top-2;
    7 Mamba, 1 attention, 4 MoE and 4 dense layers; a decode step reads
    the batch's rows of the embedding table."""
    cfg = _cell().ref_config()
    mamba = 64 * 256 + 128 * (8 + 2 * 4) + 8 * 128 + 128 * 64         # in, x, dt, out
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64
    dense = 3 * 64 * 128
    moe = 64 * 4 + 3 * 4 * 64 * 64 * 2 / 4                           # router, top-2 of 4
    head = 64 * 256
    active = 7 * mamba + attn + 4 * dense + 4 * moe + head
    assert counts.matmul_params(cfg) == active == 419_840
    b, ctx = 2, 10
    flops = 2 * active * b + 4 * b * ctx * 4 * 16 + 2 * b * 128 * 4 * 7
    assert counts.decode_flops(cfg, b, ctx) == flops
    params = (b * 64 + 7 * (mamba + 4 * 128 + 3 * 128 + 128 * 4 + 8 + 4 + 4)
              + 8 * 2 * 64 + attn + 4 * dense + 4 * (64 * 4 + 3 * 4 * 64 * 64) + 64 + head)
    kv = 2 * 2 * b * (ctx + 1) * 2 * 16
    states = 2 * 4 * b * 7 * 128 * (4 + 3)
    assert counts.decode_bytes(cfg, b, ctx) == 2 * params + kv + states
    step = counts.moe_step(cfg, b)
    assert step["flops"] == 4 * (2 * b * 2 * 3 * 64 * 64 + 2 * b * 64 * 4)
    assert step["bytes"] == 4 * (2 * 3 * 4 * 64 * 64 + 4 * 64 * 4 + 2 * 2 * b * 64)
    assert step["roofline_s"] == max(step["flops"] / counts.PEAK_BF16_FLOPS,
                                     step["bytes"] / counts.PEAK_HBM_BYTES)


def _read(metric, ctx):
    return bench.load_module(PB / "metrics" / f"{metric}.py").read(ctx)


def _ns(t):
    return int(t * 1e9) + OFFSET


def _ctx():
    """Two profiled 50 ms steps then two more; in each profiled step one
    ``models.mamba`` span and one ``models.moe`` span, each launching one
    op (4 ms and 10 ms on the device, the two MoE ops of step 1
    overlapping by 1 ms), and an op launched outside both."""
    steps = [(0.05 * i, 0.05 * (i + 1)) for i in range(4)]
    spans = []
    for a, _ in steps:
        spans += [("serve.decode", a, a + 0.02), ("models.mamba", a + 0.001, a + 0.004),
                  ("models.moe", a + 0.005, a + 0.009), ("serve.sample", a + 0.021, a + 0.022)]
    ops = [("mamba", _ns(0.010), _ns(0.014), _ns(0.002)),
           ("moe", _ns(0.014), _ns(0.024), _ns(0.006)),
           ("other", _ns(0.030), _ns(0.040), _ns(0.015)),
           ("mamba", _ns(0.060), _ns(0.064), _ns(0.052)),
           ("moe", _ns(0.064), _ns(0.070), _ns(0.056)),
           ("moe", _ns(0.069), _ns(0.074), _ns(0.058)),
           ("moe", _ns(0.080), _ns(0.081), None)]            # launch not linked
    tr = Trace([], _ns(0.0), _ns(0.1), OFFSET)
    tr.ops = ops
    return {"kind": "decode", "steps": steps, "spans": spans, "trace": tr,
            "traced_steps": 2, "profiled": steps[:2], "moe_roofline_s": 0.002}


def test_layer_readers_on_a_synthetic_trace():
    ctx = _ctx()
    assert _read("mamba_device_ms.decode", ctx) == pytest.approx(4.0)
    assert _read("moe_device_ms.decode", ctx) == pytest.approx((10 + 10) / 2)
    assert _read("moe_roofline_pct.decode", ctx) == pytest.approx(100 * 0.002 * 2 / 0.020)


@pytest.mark.parametrize("metric,span", [("moe_device_ms.decode", "models.moe"),
                                         ("moe_roofline_pct.decode", "models.moe"),
                                         ("mamba_device_ms.decode", "models.mamba")])
def test_layer_readers_read_zero_without_their_spans_and_nothing_without_the_marker(
        metric, span):
    ctx = _ctx()
    ctx["spans"] = [s for s in ctx["spans"] if s[0] != span]
    assert _read(metric, ctx) == 0.0
    ctx["spans"] = [s for s in ctx["spans"] if s[0] != "serve.sample"]
    assert _read(metric, ctx) is None
    assert _read(metric, dict(_ctx(), trace=None)) is None
    assert _read(metric, {}) is None
