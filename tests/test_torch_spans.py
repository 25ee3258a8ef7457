"""The port's spans on the paths the benchmark's cells run, on the CPU.

* ``models.scan_chunk``: one span a chunk and scan layer in forward and
  one in the backward's recompute; tracing leaves the loss and the
  gradients bit for bit as they were.
* ``serve.decode`` / ``serve.sample`` around a ``ServeEngine`` step, and
  no span with tracing off.
* ``models.moe`` (labelled with its route) and ``models.mamba`` around
  each MoE layer and Mamba mixer call of a jamba2-mini prefill and decode
  step, none of them synchronizing.
* ``optim.ortho_class.<route>``: one span a class of the plan, the
  batched one holding ``optim.ortho_stack`` and ``optim.ortho_unstack``.
* Inside a traced training step only ``train.fwd_bwd`` and
  ``train.optimizer`` synchronize.
* A span's ``time.perf_counter()`` clock, mapped by ``time.time_ns() -
  time.perf_counter_ns()``, agrees with a ``torch.profiler`` range of the
  same region.
"""

import collections
import time

import numpy as np
import pytest
import torch

from repro_torch import observability as obs
from repro_torch.configs import get_smoke_config
from repro_torch.core.plan import QRConfig
from repro_torch.data import DataConfig
from repro_torch.models import init_params
from repro_torch.models.moe import moe_forward
from repro_torch.models.transformer import map_tree
from repro_torch.observability import instrument, trace
from repro_torch.optim.batched_ortho import (batched_orthogonalize,
                                             plan_batched_ortho)
from repro_torch.serving import ServeEngine
from repro_torch.training import RunConfig, TrainConfig, Trainer
from repro_torch.training import train_step as ts
from worker_threads import share_the_cores  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _clean_observability():
    """Each test starts and ends with tracing off and no spans."""
    obs.instrument.disable()
    obs.trace.clear()
    yield
    obs.instrument.disable()
    obs.trace.clear()


def _names():
    return collections.Counter(s.name for s in trace.spans())


def _xlstm():
    """The xlstm smoke configuration (7 mLSTM + 1 sLSTM layers) in fp32."""
    return get_smoke_config("xlstm-1.3b").scaled(dtype="float32")


def test_scan_chunk_spans_forward_and_recompute_leave_the_bits():
    """A traced fwd+bwd of the xlstm smoke model records 2 x chunks x
    scan layers ``models.scan_chunk`` spans (each chunk forward, then
    recomputed in backward), labelled with the chunk length; its loss
    and every gradient equal the untraced ones bit for bit."""
    cfg = _xlstm()
    seq = 64
    chunks = seq // cfg.seq_chunk
    scan_layers = sum(s.mixer in ("mlstm", "slstm", "mamba") for s in cfg.period) \
        * cfg.n_periods
    assert chunks == 2 and scan_layers == 8
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, seq)))
             for k in ("tokens", "labels")}

    loss0, _, grads0 = ts._grads(params, batch, cfg, TrainConfig())
    assert not trace.spans()
    with instrument.enabled_scope(tracing=True, annotations=False):
        loss1, _, grads1 = ts._grads(params, batch, cfg, TrainConfig())
    spans = [s for s in trace.spans() if s.name == "models.scan_chunk"]
    assert len(spans) == 2 * chunks * scan_layers
    assert {s.labels["chunk"] for s in spans} == {cfg.seq_chunk}
    assert all(s.t_end >= s.t_start for s in spans)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_serve_engine_decode_and_sample_spans():
    """One traced ``ServeEngine`` decode step records ``serve.decode`` and
    ``serve.sample`` once each; the same step untraced records none."""
    cfg = _xlstm()
    eng = ServeEngine(init_params(torch.Generator().manual_seed(1), cfg), cfg,
                      batch=2, max_len=16, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 4)))
    logits, caches = eng.prefill(prompt)
    tok = eng.sample(logits)
    logits, caches = eng.decode(tok, caches, 4)
    tok = eng.sample(logits)
    assert not trace.spans()
    with instrument.enabled_scope(tracing=True, annotations=False):
        logits, caches = eng.decode(tok, caches, 5)
        tok = eng.sample(logits)
    assert _names() == {"serve.decode": 1, "serve.sample": 1}
    dec, smp = sorted(trace.spans(), key=lambda s: s.t_start)
    assert dec.name == "serve.decode" and dec.t_end <= smp.t_start
    assert tuple(tok.shape) == (2, 1) and tok.dtype == torch.int32


def test_moe_and_mamba_spans_record_each_layer_and_never_synchronize(monkeypatch):
    """A traced jamba2-mini prefill and decode step (7 Mamba mixers and 4
    dropless MoE layers a pass) records one ``models.mamba`` span a
    mixer call and one ``models.moe`` span a MoE layer call, labelled
    ``dropless``; qwen2-moe's MoE layer is labelled ``capacity``; no span
    calls ``Span.sync``, and the step's logits are the untraced ones."""
    cfg = get_smoke_config("jamba2-mini")
    eng = ServeEngine(init_params(torch.Generator().manual_seed(3), cfg), cfg,
                      batch=2, max_len=16, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)))
    logits, caches = eng.prefill(prompt)
    tok = eng.sample(logits)
    want, _ = eng.decode(tok, caches, 6)
    synced = []
    real = trace.Span.sync

    def recording(self, value):
        synced.append(self.name)
        return real(self, value)

    monkeypatch.setattr(trace.Span, "sync", recording)
    with instrument.enabled_scope(tracing=True, annotations=False):
        logits, caches = eng.prefill(prompt)
        got, _ = eng.decode(eng.sample(logits), caches, 6)
        qcfg = get_smoke_config("qwen2-moe-a2.7b")
        qp = init_params(torch.Generator().manual_seed(4), qcfg).tree()["layers"][0]["moe"]
        moe_forward(map_tree(lambda t: t[0], qp), torch.randn(1, 8, qcfg.d_model), qcfg)
    assert synced == []
    assert torch.equal(want, got)
    names = _names()
    mamba = sum(s.mixer == "mamba" for s in cfg.period) * cfg.n_periods
    moe = sum(s.ffn == "moe" for s in cfg.period) * cfg.n_periods
    assert (mamba, moe) == (7, 4)
    assert names["models.mamba"] == 2 * mamba and names["models.moe"] == 2 * moe + 1
    routes = collections.Counter(s.labels["route"] for s in trace.spans()
                                 if s.name == "models.moe")
    assert routes == {"dropless": 2 * moe, "capacity": 1}


def test_ortho_class_spans_name_their_route():
    """A batched class and a singleton class: one ``optim.ortho_class
    .<route>`` span a class of the plan, the batched one holding one
    ``optim.ortho_stack`` and one ``optim.ortho_unstack``, all under
    ``optim.batched_ortho``; the Qs are those of the untraced call."""
    rng = np.random.default_rng(2)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in [(3, 64, 32), (48, 24)]]
    plan = plan_batched_ortho([(tuple(l.shape), l.dtype) for l in leaves],
                              backend="cpu")
    routes = sorted(c.route for c in plan.classes)
    assert routes == ["batched", "leafwise"]
    want = batched_orthogonalize(leaves, device="cpu")
    with instrument.enabled_scope(tracing=True, annotations=False):
        got = batched_orthogonalize(leaves, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    spans = trace.spans()
    by_sid = {s.sid: s for s in spans}
    classes = [s for s in spans if s.name.startswith("optim.ortho_class.")]
    assert sorted(s.name.rsplit(".", 1)[1] for s in classes) == routes
    for s in classes:
        assert s.labels["route"] == s.name.rsplit(".", 1)[1]
        assert by_sid[s.parent_sid].name == "optim.batched_ortho"
    (batched,) = [s for s in classes if s.name == "optim.ortho_class.batched"]
    kids = sorted((s for s in spans if s.parent_sid == batched.sid),
                  key=lambda s: s.t_start)
    assert [s.name for s in kids] == ["optim.ortho_stack", "optim.ortho_unstack"]
    assert all(batched.t_start <= s.t_start <= s.t_end <= batched.t_end
               for s in kids)


def test_only_the_step_spans_synchronize(monkeypatch):
    """A traced QR-Muon training step of the xlstm smoke model (the
    batched classes on the tiled engine) calls ``Span.sync`` from
    ``train.fwd_bwd`` and ``train.optimizer`` only, once each, though
    it also opens the data, scan, class and engine spans."""
    cfg = get_smoke_config("xlstm-1.3b")
    tr = Trainer(cfg, TrainConfig(optimizer="muon-qr", batched_ortho=True, lr=0.01,
                                  qr_config=QRConfig(method="tiled", block=16)),
                 RunConfig(total_steps=2, warmup_steps=1, log_every=1),
                 DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2,
                            seed=0),
                 device="cpu", log_fn=lambda s: None)
    synced = []
    real = trace.Span.sync

    def recording(self, value):
        synced.append(self.name)
        return real(self, value)

    monkeypatch.setattr(trace.Span, "sync", recording)
    with instrument.enabled_scope(tracing=True, annotations=False):
        tr.run(stop_at=1)
    assert synced == ["train.fwd_bwd", "train.optimizer"]
    names = _names()
    for name in ("train.data", "models.scan_chunk", "optim.batched_ortho",
                 "optim.ortho_class.batched", "optim.ortho_stack",
                 "optim.ortho_unstack", "engine.factor_tiles_batched"):
        assert names[name] >= 1, (name, names)


def test_span_clock_maps_onto_the_profiler_clock():
    """A span and the ``record_function`` range it opens (annotations on)
    start and end within 1 ms of each other once the span's
    ``perf_counter`` times are mapped by ``time.time_ns() -
    time.perf_counter_ns()``, as the benchmark maps them."""
    with instrument.enabled_scope(tracing=True, annotations=True):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            offset = time.time_ns() - time.perf_counter_ns()
            with torch.profiler.record_function("warm-up"):
                pass
            with trace.span("test.region"):
                torch.ones(64).sum()
                time.sleep(0.01)
    (sp,) = [s for s in trace.spans() if s.name == "test.region"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "test.region"]
    start = int(sp.t_start * 1e9) + offset
    end = int(sp.t_end * 1e9) + offset
    assert abs(ev.start_ns() - start) < 1_000_000
    assert abs(ev.start_ns() + ev.duration_ns() - end) < 1_000_000
