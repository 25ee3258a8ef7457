"""The port's observability layer (``repro_torch.observability``) against
the reference's (``repro.observability``).

Each test twins one of tests/test_observability.py on the port: the
metrics registry (a copy of the reference's, held to the same snapshot
and Prometheus text on the same operations), the span tracer (disabled
spans are one shared no-op, enabled spans nest, sync waits for the CUDA
devices of the tensors it is given, the Chrome export round-trips), the
disabled-mode overhead gate (< 1% of a CPU tiled 256² solve), the
planner's, engine's and TSQR's counters beside the reference's, and a
traced serving run through the port's ``QRService`` on the CPU.  The
reference's abstract-tracer case has no counterpart (the port traces no
programs); its twin here checks that ``sync`` walks nested values.
"""

import json
import threading
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import observability as jobs
from repro.core import engine as jeng
import repro_torch
from repro_torch import observability as obs
from repro_torch.core import engine as teng
from repro_torch.observability import (instrument, metrics, profiler, report,
                                       trace)
from repro_torch.serving import BucketingPolicy, QRService
from worker_threads import share_the_cores  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _clean_observability():
    """Each test starts disabled with empty registries/span buffers (the
    port's and the reference's) and leaves the process the same way."""
    for mod in (obs, jobs):
        mod.instrument.disable()
        mod.metrics.reset()
        mod.trace.clear()
    yield
    for mod in (obs, jobs):
        mod.instrument.disable()
        mod.metrics.reset()
        mod.trace.clear()


def _service(**kw):
    kw.setdefault("policy", BucketingPolicy(tile=16, max_batch=4))
    kw.setdefault("device", "cpu")
    return QRService(**kw)


# ------------------------------------------------------------------ metrics

def test_counter_labels_and_totals():
    metrics.counter("t.requests", route="a").inc()
    metrics.counter("t.requests", route="a").inc(2)
    metrics.counter("t.requests", route="b").inc(5)
    assert metrics.counter_value("t.requests", route="a") == 3
    assert metrics.counter_value("t.requests", route="b") == 5
    assert metrics.counter_value("t.requests", route="zzz") == 0
    assert metrics.counter_total("t.requests") == 8


def test_counter_rejects_negative():
    with pytest.raises(ValueError):
        metrics.counter("t.bad").inc(-1)


def test_gauge_set_inc_dec():
    g = metrics.gauge("t.depth", tree="x")
    g.set(4)
    g.inc()
    g.dec(2)
    assert metrics.snapshot()["gauges"]["t.depth"][0]["value"] == 3


def test_histogram_percentiles_and_snapshot():
    h = metrics.histogram("t.lat")
    for v in [1.0] * 90 + [100.0] * 10:
        h.observe(v)
    snap = metrics.snapshot()["histograms"]["t.lat"][0]
    assert snap["count"] == 100
    assert snap["min"] == 1.0 and snap["max"] == 100.0
    assert h.percentile(50) < 5.0
    assert h.percentile(99) > 50.0
    assert 1.0 < h.mean < 100.0


def test_prometheus_export_format():
    metrics.counter("serve.reqs", route="a").inc(3)
    metrics.histogram("serve.lat").observe(0.5)
    text = metrics.to_prometheus()
    assert '# TYPE serve_reqs_total counter' in text
    assert 'serve_reqs_total{route="a"} 3' in text
    assert '# TYPE serve_lat histogram' in text
    assert 'serve_lat_bucket{le="+Inf"} 1' in text
    assert "serve_lat_count 1" in text


def test_registry_matches_reference_on_same_operations():
    """The copy against the reference: the same operations give the same
    snapshot and the same Prometheus text."""
    rng = np.random.default_rng(3)
    values = rng.lognormal(3.0, 2.0, 200).tolist()
    for reg in (metrics, jobs.metrics):
        reg.counter("x.calls", mode="megakernel", phase="execute").inc(4)
        reg.counter("x.calls", mode="wavefront", phase="execute").inc()
        reg.gauge("x.table_bytes", grid="4x4").set(1234)
        h = reg.histogram("x.lat", service="qr0")
        for v in values:
            h.observe(v)
        reg.histogram("x.fill", buckets=(0.25, 0.5, 1.0)).observe(0.75)
    assert metrics.snapshot() == jobs.metrics.snapshot()
    assert metrics.to_prometheus() == jobs.metrics.to_prometheus()


def test_registry_thread_safety_raw_counters():
    n_threads, n_incs = 8, 5000

    def worker():
        for _ in range(n_incs):
            metrics.counter("t.contended", shared="yes").inc()

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert metrics.counter_value("t.contended",
                                 shared="yes") == n_threads * n_incs


def test_registry_thread_safety_under_submit_many():
    """Concurrent serving traffic from threads keeps every service's
    registry-backed stats exact (the counters behind ``stats()`` share
    one process-global registry)."""
    rng = np.random.default_rng(0)
    waves = [[rng.standard_normal((12, 12), dtype=np.float32)
              for _ in range(6)] for _ in range(4)]
    services = [_service() for _ in range(4)]
    errs = []

    def worker(svc, wave):
        try:
            svc.submit_many(wave)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(svc, wave))
               for svc, wave in zip(services, waves)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs
    for svc in services:
        s = svc.stats()
        assert s["requests"] == s["matrices_served"] == 6
    assert metrics.counter_total("serving.requests") >= 24


def test_fresh_service_instances_start_at_zero():
    a = np.eye(8, dtype=np.float32)
    s1 = _service()
    s1.submit_many([a])
    s2 = _service()
    assert s1.stats()["requests"] == 1
    assert s2.stats()["requests"] == 0


# ------------------------------------------------------------------- tracer

def test_span_disabled_is_shared_noop_singleton():
    s1, s2 = trace.span("a"), trace.span("b", k=1)
    assert s1 is s2
    with s1 as sp:
        sp.set(more="labels")
    assert trace.spans() == []


def _cuda_probe(index=0):
    """A stand-in for a tensor on CUDA device ``index``: a Tensor-spec'd
    mock whose ``device`` is that card."""
    probe = mock.Mock(spec=torch.Tensor)
    probe.device = torch.device("cuda", index)
    return probe


def test_sync_noop_when_disabled_blocks_when_enabled(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    probe = _cuda_probe()
    out = trace.span("x").sync(probe)
    assert out is probe and synced == []       # disabled: never syncs
    with obs.enabled_scope():
        with trace.span("x") as sp:
            assert sp.sync(probe) is probe
    assert synced == [torch.device("cuda", 0)]  # enabled: waits for the card


def test_sync_walks_nested_values(monkeypatch):
    """The port's counterpart of the reference's tracer case: ``sync``
    finds the CUDA tensors in tuples, lists and dicts (one synchronize a
    device) and leaves CPU tensors and other leaves alone."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    value = ((_cuda_probe(0), torch.ones(2)), [None, 3, _cuda_probe(1)],
             {"r": _cuda_probe(0)})
    with obs.enabled_scope():
        with trace.span("x") as sp:
            assert sp.sync(value) is value
    assert sorted(d.index for d in synced) == [0, 1]


def test_span_nesting_and_ordering():
    with obs.enabled_scope():
        with trace.span("outer", wave=0) as outer:
            with trace.span("inner.a") as a:
                pass
            with trace.span("inner.b") as b:
                pass
    done = trace.spans()
    assert [s.name for s in done] == ["inner.a", "inner.b", "outer"]
    assert a.parent_sid == outer.sid and b.parent_sid == outer.sid
    assert a.depth == b.depth == 1 and outer.depth == 0
    assert outer.t_start <= a.t_start <= a.t_end <= b.t_start <= outer.t_end
    assert "outer" in trace.tree() and "  inner.a" in trace.tree()


def test_traced_decorator():
    @trace.traced("deco.name", kind="unit")
    def work():
        return 7

    assert work() == 7
    with obs.enabled_scope():
        assert work() == 7
    (sp,) = trace.spans()
    assert sp.name == "deco.name" and sp.labels == {"kind": "unit"}


def test_chrome_trace_round_trip(tmp_path):
    with obs.enabled_scope():
        with trace.span("parent", bucket="64x64"):
            with trace.span("child"):
                time.sleep(0.001)
    path = trace.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads(open(path).read())
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert [e["name"] for e in events] == ["parent", "child"]
    for e in events:
        assert e["ph"] == "X"
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert e["dur"] >= 0
    assert events[0]["args"] == {"bucket": "64x64"}
    child, parent = events[1], events[0]
    assert parent["ts"] <= child["ts"]
    assert child["ts"] + child["dur"] <= parent["ts"] + parent["dur"] + 1e-3
    # The reference's renderer reads the port's export as its own.
    from repro.observability import report as jreport
    assert report._render_trace(doc) == jreport._render_trace(doc)


def test_enabled_scope_restores_prior_state():
    assert not instrument.tracing_enabled()
    with obs.enabled_scope():
        assert instrument.tracing_enabled()
        assert instrument.annotations_enabled()
    assert not instrument.tracing_enabled()
    instrument.enable(tracing=False, annotations=True)
    with obs.enabled_scope():
        pass
    assert instrument.annotations_enabled()
    assert not instrument.tracing_enabled()


# ---------------------------------------------------------------- profiler

def test_labels_match_reference():
    for args in [("GEQRT", 3), ("SSRFB", None), ("QLARFB", 0)]:
        assert profiler.kernel_label(*args) == jobs.kernel_label(*args)
    for args in [(16, 16), (20, 20, 1), (24, 6, 64)]:
        assert profiler.megakernel_label(*args) == jobs.megakernel_label(*args)


def test_annotate_is_null_when_disabled_and_a_profiler_range_when_on(
        tmp_path):
    """Disabled: one shared null context.  Under ``capture`` the engine's
    launches and the spans carry their names into the torch.profiler
    trace: the wavefront batches as ``geqrt@L0`` ..., the megakernel as
    ``megakernel[...]``."""
    assert profiler.annotate("x") is profiler.annotate("y")
    rng = np.random.default_rng(4)
    ws = [torch.from_numpy(rng.standard_normal((2, 2, 8, 8), np.float32))
          for _ in range(2)]
    with profiler.capture(str(tmp_path)):
        with obs.span("test.factor"):
            teng.factor_tiles(ws[0], p=2, q=2, nb=8, use_kernel=True,
                              dispatch_mode="wavefront")
            teng.factor_tiles(ws[1], p=2, q=2, nb=8, use_kernel=True,
                              dispatch_mode="megakernel")
    doc = json.loads((tmp_path / profiler.PROFILE_FILE).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"test.factor", "engine.factor_tiles", "geqrt@L0",
            "megakernel[2x2]"} <= names
    assert not instrument.tracing_enabled()     # capture restored the state
    assert metrics.counter_total("profiler.capture_errors") == 0


# ----------------------------------------------------------------- overhead

def test_disabled_overhead_budget():
    """The disabled-mode budget: one span + sync must cost < 1% of a CPU
    tiled 256² solve (the reference's gate, on the port)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 256), dtype=np.float32))
    solver = repro_torch.plan(a.shape, a.dtype, repro_torch.QRConfig(
        method="tiled", mode="r", block=64, use_kernel=False), backend="cpu")
    solver.solve(a)
    t0 = time.perf_counter()
    solver.solve(a)
    solve_s = time.perf_counter() - t0

    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        with trace.span("overhead.probe", mode="megakernel") as sp:
            sp.sync(None)
    per_call_s = (time.perf_counter() - t0) / n
    assert per_call_s < 0.01 * solve_s, (
        f"disabled span costs {per_call_s * 1e6:.2f} us/call, "
        f"> 1% of the {solve_s * 1e3:.2f} ms tiled 256^2 solve")


# ------------------------------------------------------- planner / pipeline

def test_planner_emits_plan_and_fallback_counters():
    """The port's planner counts as the reference's does, label for
    label, on the same plans."""
    from repro.core import QRConfig as JQRConfig
    from repro.core import plan as jplan

    repro_torch.plan((512, 512), torch.float32,
                     repro_torch.QRConfig(use_tuning_cache=False),
                     backend="cpu")
    jplan((512, 512), jnp.float32, JQRConfig(use_tuning_cache=False),
          backend="cpu")
    assert metrics.counter_value("planner.plans", method="tiled") == 1
    assert jobs.metrics.counter_value("planner.plans", method="tiled") == 1
    repro_torch.plan((300, 280), torch.float32, repro_torch.QRConfig(
        use_tuning_cache=False), backend="cpu")
    jplan((300, 280), jnp.float32, JQRConfig(use_tuning_cache=False),
          backend="cpu")
    for reg in (metrics, jobs.metrics):
        assert reg.counter_value(
            "planner.fallbacks", reason="tiled_min_dim_cpu_floor") == 1
    # The kernel path's over-budget fallback (resolve hook).
    repro_torch.plan((2048, 2048), torch.float32, backend="cuda")
    assert metrics.counter_value(
        "planner.fallbacks", reason="megakernel_over_budget") == 1


def test_engine_emits_dispatch_and_dma_series():
    """The engine's series on the port's megakernel lowering (the plain
    walk on the CPU) equal the reference's on its eager megakernel call:
    one dispatch, the roofline traffic, and the same labels.  The
    reference's ``engine.modeled_dma_bytes`` (a TPU tile model, read by
    nothing of the port's) has no series in the port."""
    p = q = 3
    nb = 8
    rng = np.random.default_rng(1)
    tiles = rng.standard_normal((p, q, nb, nb), dtype=np.float32)
    teng.factor_tiles(torch.from_numpy(tiles.copy()), p=p, q=q, nb=nb,
                      use_kernel=True, dispatch_mode="megakernel")
    jax.block_until_ready(jeng.factor_tiles(
        jnp.asarray(tiles), p=p, q=q, nb=nb, use_kernel=True, interpret=True,
        dispatch_mode="megakernel").tiles)
    st = teng.schedule_stats(p, q, nb)
    for reg in (metrics, jobs.metrics):
        assert reg.counter_value("engine.dispatches", mode="megakernel",
                                 phase="execute") == 1
    assert jobs.metrics.counter_value(
        "engine.modeled_dma_bytes", mode="megakernel",
        phase="execute") == st["megakernel"]["modeled_dma_bytes"]
    assert "engine.modeled_dma_bytes" not in metrics.snapshot()["counters"]
    for name in ("engine.matrices", "engine.tasks",
                 "engine.roofline_dma_bytes"):
        assert metrics.counter_total(name) == jobs.metrics.counter_total(name)
    assert metrics.snapshot()["gauges"]["engine.table_bytes"] == \
        jobs.metrics.snapshot()["gauges"]["engine.table_bytes"]


def test_tsqr_counters():
    """``tsqr.solves`` and ``tsqr.tree_depth`` with the reference's
    labels, once per solve of a tall-skinny matrix."""
    a = np.random.default_rng(5).standard_normal((256, 16)).astype(np.float32)
    solver = repro_torch.plan(a.shape, torch.float32, backend="cpu")
    assert solver.config.method == "tsqr"
    repro_torch.qr(a, device="cpu")
    nbk = solver.config.nblocks
    assert metrics.counter_value("tsqr.solves", nblocks=nbk,
                                 mode="reduced") == 1
    (g,) = metrics.snapshot()["gauges"]["tsqr.tree_depth"]
    assert g == {"labels": {"nblocks": str(nbk)},
                 "value": float((nbk - 1).bit_length())}


def test_end_to_end_capture_covers_serving_pipeline():
    """A traced serving run yields Chrome-trace spans covering the full
    bucketize -> plan -> dispatch -> unpad pipeline plus the serving
    histograms."""
    rng = np.random.default_rng(2)
    svc = _service()
    with obs.enabled_scope():
        svc.submit_many([rng.standard_normal((12, 10), dtype=np.float32)
                         for _ in range(3)])
    names = {s.name for s in trace.spans()}
    assert {"serving.bucketize", "serving.plan", "serving.dispatch",
            "serving.unpad", "engine.factor_tiles_batched"} <= names
    doc = trace.chrome_trace()
    assert len(doc["traceEvents"]) == len(trace.spans())
    snap = metrics.snapshot()
    for h in ("serving.queue_wait_seconds", "serving.latency_seconds",
              "serving.bucket_fill", "serving.padding_waste"):
        assert h in snap["histograms"], h
    assert metrics.counter_value("serving.dispatches",
                                 service=svc._sid) == 1


def test_report_capture_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.observability.report --capture DIR --device
    cpu``: the trace, metrics and Prometheus files, rendered."""
    assert report.main(["--capture", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "serving.dispatch" in out and "planner.plans" in out
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"smoke.capture", "smoke.serve", "serving.plan"} <= names
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert snap["counters"]["planner.fallbacks"][0]["labels"] == {
        "reason": "tiled_min_dim_cpu_floor"}
    assert "serving_requests_total" in (tmp_path / "metrics.prom").read_text()
