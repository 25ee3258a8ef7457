"""The readers of the program's own spans, on synthetic traced runs: the
hand-computed value, 0.0 where the run has the program's spans but not
the reader's (a route left empty), and None on nothing or on a run of a
program that records none of these spans."""

from types import SimpleNamespace

import pytest

from perfbench import bench

PB = bench.ROOT / "perfbench"
OFFSET = 7_000_000_000          # perf_counter ns -> the trace's clock


def _read(metric, ctx):
    return bench.load_module(PB / "metrics" / f"{metric}.py").read(ctx)


def _ns(t):
    return int(t * 1e9) + OFFSET


def _train_ctx(leafwise=True):
    """Three 1 s steps, the last profiled; two scan chunks in step 0, one
    in step 1, two in the profiled step; a batched and (optionally) a
    leafwise class a step."""
    steps = [(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]
    spans = [("train.data", a, a + 0.01) for a, _ in steps]
    spans += [("train.fwd_bwd", a + 0.01, a + 0.5) for a, _ in steps]
    spans += [("models.scan_chunk", 0.1, 0.2), ("models.scan_chunk", 0.3, 0.35),
              ("models.scan_chunk", 1.1, 1.3),
              ("models.scan_chunk", 2.1, 2.2), ("models.scan_chunk", 2.5, 2.6)]
    spans += [("optim.ortho_class.batched", a + 0.6, a + 0.75) for a, _ in steps]
    if leafwise:
        spans += [("optim.ortho_class.leafwise", a + 0.8, a + 0.82) for a, _ in steps]
    ops = [("k", _ns(2.16), _ns(2.17), _ns(2.15)),      # inside a chunk
           ("k", _ns(2.56), _ns(2.57), _ns(2.55)),      # inside the other
           ("k", _ns(2.61), _ns(2.62), _ns(2.6)),       # at a chunk's end
           ("k", _ns(2.31), _ns(2.32), _ns(2.3)),       # between chunks
           ("k", _ns(2.11), _ns(2.12), None)]           # launch not linked
    return {"kind": "train", "steps": steps, "spans": spans, "traced_steps": 1,
            "profiled": steps[-1:], "trace": SimpleNamespace(ops=ops, offset=OFFSET)}


def _decode_ctx():
    """Four steps of 50 ms, the first two profiled; ``serve.decode`` of
    10, 11, 12 and 14 ms."""
    steps = [(0.05 * i, 0.05 * (i + 1)) for i in range(4)]
    spans = []
    for (a, _), d in zip(steps, (0.010, 0.011, 0.012, 0.014)):
        spans += [("ServeEngine.decode", a, a + d + 0.001), ("serve.decode", a, a + d),
                  ("serve.sample", a + d + 0.001, a + d + 0.002)]
    return {"kind": "decode", "steps": steps, "spans": spans, "traced_steps": 2,
            "profiled": steps[:2], "trace": SimpleNamespace(ops=[], offset=OFFSET)}


def test_scan_host_ms_sums_the_chunks_of_the_unprofiled_steps():
    assert _read("scan_host_ms.train", _train_ctx()) == pytest.approx(1e3 * 0.35 / 2)


def test_scan_device_ops_counts_launches_inside_the_chunks():
    assert _read("scan_device_ops.train", _train_ctx()) == 3.0


def test_ortho_host_ms_by_route():
    ctx = _train_ctx()
    assert _read("ortho_batched_host_ms.train", ctx) == pytest.approx(150.0)
    assert _read("ortho_leafwise_host_ms.train", ctx) == pytest.approx(20.0)


def test_decode_host_ms_over_the_unprofiled_steps():
    assert _read("decode_host_ms.decode", _decode_ctx()) == pytest.approx(13.0)


@pytest.mark.parametrize("metric,drop", [
    ("scan_host_ms.train", "models.scan_chunk"),
    ("scan_device_ops.train", "models.scan_chunk"),
    ("ortho_batched_host_ms.train", "optim.ortho_class.batched"),
    ("ortho_leafwise_host_ms.train", "optim.ortho_class.leafwise"),
    ("decode_host_ms.decode", "serve.decode"),
])
def test_an_absent_span_reads_zero_and_an_older_program_nothing(metric, drop):
    ctx = _decode_ctx() if metric.endswith(".decode") else _train_ctx()
    ctx["spans"] = [s for s in ctx["spans"] if s[0] != drop]
    assert _read(metric, ctx) == 0.0
    marker = "serve.sample" if metric.endswith(".decode") else "train.data"
    ctx["spans"] = [s for s in ctx["spans"] if s[0] != marker]
    assert _read(metric, ctx) is None
    assert _read(metric, {}) is None


def test_leafwise_reads_zero_where_the_plan_has_no_leafwise_class():
    assert _read("ortho_leafwise_host_ms.train", _train_ctx(leafwise=False)) == 0.0


def test_device_ops_need_a_trace():
    ctx = dict(_train_ctx(), trace=None)
    assert _read("scan_device_ops.train", ctx) is None
    assert _read("scan_host_ms.train", ctx) == pytest.approx(175.0)
