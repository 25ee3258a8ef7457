"""The port's tuning layer (``repro_torch.tuning``) and the planner's
``tuned`` rule against the reference's (``repro.tuning``), on the CPU.

- Shape classes: equal on a grid of shapes (exact ints).
- The schema: a cache one package writes, the other loads, entry for
  entry (exact values).
- The ``tuned`` rule: with the reference's ``default_cpu.json`` loaded
  through each package's own loader and installed in both, ``plan(...,
  backend="cpu")`` gives the same decision trail (rules, outcomes and
  reasons) and the same method, block, dispatch mode and ``use_kernel``
  over square, tall and wide shapes from 32 to 1024 in fp32 and fp64
  (exact).  The deliberate differences are asserted as such: a tuned
  method that cannot honor ``use_kernel=True`` is rejected (ROADMAP C3),
  and a tuned dispatch mode applies only where the entry measured both
  lowerings (C7).
- ``check_cache`` and a tiny CPU sweep end to end; the sweep's candidate
  grid on "cuda" (plan only) measures the heuristic pick once.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.plan import QRConfig as JConfig
from repro.core.plan import plan as jplan
from repro.tuning import cache as jcache
from repro_torch.core.plan import QRConfig, plan, select_method
from repro_torch.observability import metrics
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import sweep
from repro_torch.tuning.cache import (TunedConfig, TuningCache, TuningEntry,
                                      set_active_cache, shape_class)
from worker_threads import share_the_cores  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _restore_active_caches():
    """Every test leaves both packages' active caches as it found them."""
    prev, jprev = set_active_cache(None), jcache.set_active_cache(None)
    yield
    set_active_cache(prev)
    jcache.set_active_cache(jprev)


def _entry(m=2048, n=2048, method="tiled", block=64, backend="cpu",
           device_kind="cpu", dtype="float32", best_us=100.0,
           heuristic_us=200.0, timings=None, **kw):
    return TuningEntry(
        backend=backend, device_kind=device_kind, shape_class=(m, n),
        dtype=dtype, best=TunedConfig(method=method, block=block, **kw),
        best_us=best_us, heuristic_method="geqrf_ht",
        heuristic_us=heuristic_us,
        timings=tuple(sorted(timings.items())) if timings is not None else
        tuple(sorted(((f"{method}[b{block}]", best_us),
                      ("geqrf_ht", heuristic_us)))))


def _both_defaults():
    """The reference's committed CPU cache, loaded through each
    package's own loader and installed in both."""
    mine = TuningCache.load(jcache.DEFAULT_CACHE_PATH)
    ref = jcache.TuningCache.load(jcache.DEFAULT_CACHE_PATH)
    set_active_cache(mine)
    jcache.set_active_cache(ref)
    return mine, ref


# ------------------------------------------------------------ shape classes

def test_shape_class_equals_reference():
    dims = sorted({1, 2, 31, 32, 33, 64, 95, 96, 128, 150, 192, 200, 255,
                   256, 300, 384, 500, 511, 576, 640, 700, 768, 1000, 1024,
                   1536, 2048, 3000})
    for m in dims:
        for n in dims:
            assert shape_class(m, n) == jcache.shape_class(m, n), (m, n)
    for f in (shape_class, jcache.shape_class):
        with pytest.raises(ValueError, match="nonempty"):
            f(0, 5)


# ------------------------------------------------------------- the schema

def test_schema_and_loader_are_the_references():
    assert tcache.SCHEMA == jcache.SCHEMA == "qr-tuning-v1"
    mine, ref = _both_defaults()
    assert [e.to_dict() for e in mine.entries()] == \
        [e.to_dict() for e in ref.entries()]


def test_a_cache_one_package_writes_the_other_loads(tmp_path):
    kernel = _entry(method="tiled", block=32, backend="cuda",
                    device_kind="NVIDIA H100 80GB HBM3", m=768, n=768,
                    use_kernel=True, dispatch_mode="wavefront",
                    timings={"tiled[b32,wavefront]": 90.0, "geqrf_ht": 120.0})
    plain = _entry(method="geqrf", block=32, dtype="float64")
    path = str(tmp_path / "port.json")
    TuningCache([kernel, plain], source="test").save(path)
    ref = jcache.TuningCache.load(path)
    assert sorted(json.dumps(e.to_dict(), sort_keys=True)
                  for e in ref.entries()) == \
        sorted(json.dumps(e.to_dict(), sort_keys=True)
               for e in (kernel, plain))
    path2 = str(tmp_path / "ref.json")
    ref.save(path2)
    back = TuningCache.load(path2)
    got = back.lookup(backend="cuda", m=640, n=640, dtype=torch.float32)
    assert got == kernel
    assert back.lookup(backend="cpu", m=2000, n=2000,
                       dtype=torch.float64) == plain
    assert back.lookup(backend="cpu", m=2000, n=2000,
                       dtype=np.float64) == plain
    with open(path) as f:
        assert json.load(f)["schema"] == jcache.SCHEMA


def test_schema_mismatch_raises(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"schema": "qr-tuning-v0", "entries": []}))
    with pytest.raises(ValueError, match="schema"):
        TuningCache.load(str(path))


def test_lookup_prefers_exact_device_kind_and_replaces_same_kind():
    a = _entry(device_kind="cpu", best_us=10.0)
    b = _entry(device_kind="other", best_us=20.0, method="geqrf")
    c = TuningCache([a, b])
    assert len(c) == 2
    assert c.lookup(backend="cpu", m=2048, n=2048, dtype=torch.float32,
                    device_kind="other").best.method == "geqrf"
    assert c.lookup(backend="cpu", m=2048, n=2048, dtype=torch.float32,
                    device_kind="mystery") in (a, b)
    assert c.lookup(backend="cpu", m=0, n=2048, dtype=torch.float32) is None
    c.add(_entry(device_kind="cpu", best_us=5.0, method="geqrf_ht"))
    assert len(c) == 2


# ------------------------------------------------- the default and the env

def test_no_default_cache_is_committed_and_plan_says_so():
    """No card sweep is committed yet: the default loads as missing and
    the ``tuned`` rule rejects on every shape the card's phases drive."""
    assert not os.path.exists(tcache.DEFAULT_CACHE_PATH)
    assert os.path.basename(tcache.DEFAULT_CACHE_PATH) == "default_cuda.json"
    c = tcache.active_cache()
    assert len(c) == 0 and c.source.startswith("missing:")
    for shape in ((2048, 2048), (640, 640), (60, 576, 576), (60, 576, 192),
                  (4096, 4096), (49152, 576), (200, 200), (16, 1000),
                  (90, 1536, 576)):
        d = plan(shape, torch.float32, backend="cuda",
                 explain=True).explain.decision("tuned")
        assert d.outcome == "rejected"
        assert d.reason.startswith("no tuning cache loaded")


def test_env_var_is_the_ports_own(tmp_path, monkeypatch):
    path = str(tmp_path / "env.json")
    TuningCache([_entry(method="geqrf", block=32)]).save(path)
    monkeypatch.setenv(jcache.ENV_VAR, path)    # the reference's variable
    set_active_cache(None)
    assert tcache.ENV_VAR == "REPRO_TORCH_TUNING_CACHE" != jcache.ENV_VAR
    assert len(tcache.active_cache()) == 0      # never routes the port
    monkeypatch.setenv(tcache.ENV_VAR, path)
    set_active_cache(None)
    info = tcache.active_cache_info()
    assert info["source"] == path and info["entries"] == 1
    assert info["classes"] == ["cpu:2048x2048:float32"]


def test_env_var_missing_file_warns(tmp_path, monkeypatch):
    monkeypatch.setenv(tcache.ENV_VAR, str(tmp_path / "nope.json"))
    set_active_cache(None)
    with pytest.warns(UserWarning, match="does not exist"):
        assert len(tcache.active_cache()) == 0


# ------------------------------------- the tuned rule against the reference

_SIZES = (32, 48, 64, 96, 128, 200, 256, 300, 384, 400, 512, 640, 768, 1024)
_GRID = ([(s, s) for s in _SIZES] + [(2 * s, s) for s in _SIZES if s <= 512]
         + [(s, 2 * s) for s in _SIZES if s <= 512]
         + [(4 * s, s) for s in (32, 64, 256)])


def _trail(decisions):
    return [(d.rule, d.outcome, d.reason) for d in decisions]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", _GRID)
def test_tuned_routes_equal_reference(shape, dtype):
    """With the same cache in both, the auto route on "cpu" is the
    reference's: the same trail, method, block, dispatch mode and
    ``use_kernel`` — the tuned rejections that were the only auto-route
    differences at 200-512 are gone."""
    _both_defaults()
    mine = plan(shape, getattr(torch, dtype), backend="cpu", explain=True)
    ref = jplan(shape, getattr(jnp, dtype), backend="cpu", explain=True)
    assert _trail(mine.explain.decisions) == _trail(ref.explain.decisions)
    for knob in ("method", "block", "dispatch_mode", "use_kernel"):
        assert getattr(mine.config, knob) == getattr(ref.config, knob), knob
    assert select_method(shape, getattr(torch, dtype), QRConfig(),
                         backend="cpu") == ref.config.method


def test_tuned_routes_differ_without_the_cache():
    """The control: the port's empty default routes the 256 class to the
    heuristic pick, where the reference's cache picks geqrf."""
    jcache.set_active_cache(jcache.TuningCache.load(jcache.DEFAULT_CACHE_PATH))
    assert plan((256, 256), torch.float32, backend="cpu").config.method == \
        "geqrf_ht"
    assert jplan((256, 256), jnp.float32, backend="cpu").config.method == \
        "geqrf"


@pytest.mark.parametrize("shape", [(300, 300), (256, 256), (384, 384)])
def test_c3_tuned_method_without_kernels_is_rejected(shape):
    """ROADMAP C3: the reference plans the cache's ``geqrf`` under
    ``use_kernel=True`` and raises; the port rejects the ``tuned`` rule
    and routing falls through to the heuristics, which honor it."""
    _both_defaults()
    cfg = QRConfig(use_kernel=True)
    with pytest.raises(ValueError, match="no kernel-backed realization"):
        jplan(shape, jnp.float32, JConfig(use_kernel=True), backend="cpu")
    s = plan(shape, torch.float32, cfg, backend="cpu", explain=True)
    d = s.explain.decision("tuned")
    assert d.outcome == "rejected" and "use_kernel=True" in d.reason
    assert s.config.use_kernel is True
    assert s.config.method == select_method(
        shape, torch.float32, QRConfig(use_kernel=True, use_tuning_cache=False),
        backend="cpu")


def _edge_entry(backend, timings, mode="wavefront"):
    """A 768^2 entry whose best is the b32 wavefront lowering — what a
    sweep measures at the class edge, where b32's megakernel is over its
    table budget."""
    return TuningEntry(
        backend=backend, device_kind=backend, shape_class=(768, 768),
        dtype="float32",
        best=TunedConfig(method="tiled", block=32, dispatch_mode=mode,
                         use_kernel=True),
        best_us=min(timings.values()), heuristic_method="tiled",
        heuristic_us=timings["tiled[b32,wavefront]"],
        timings=tuple(sorted(timings.items())))


@pytest.mark.parametrize("shape", [(640, 640), (576, 576), (60, 576, 576)])
def test_c7_edge_entry_keeps_the_megakernel(shape):
    """ROADMAP C7: an entry that measured only the wavefront lowering at
    its class edge does not force it on members whose grid fits the
    megakernel; the reference's does (asserted as the difference)."""
    timings = {"tiled[b32,wavefront]": 900.0, "geqrf_ht": 1500.0}
    set_active_cache(TuningCache([_edge_entry("cuda", timings)]))
    jcache.set_active_cache(jcache.TuningCache([jcache.TuningEntry.from_dict(
        _edge_entry("tpu", timings).to_dict())]))
    s = plan(shape, torch.float32, backend="cuda", explain=True)
    assert s.explain.selected.rule == "tuned"
    assert (s.config.method, s.config.use_kernel, s.config.dispatch_mode) \
        == ("tiled", True, "megakernel")
    d = s.explain.decision("tuned_config")
    assert d.outcome == "resolved" and "not applied" in d.reason
    assert s.explain.decision("dispatch_mode_auto").outcome == "resolved"
    ref = jplan(shape, jnp.float32, backend="tpu", explain=True)
    assert ref.explain.selected.rule == "tuned"
    assert ref.config.dispatch_mode == "wavefront"   # the reference's defect
    # Measured at a grid that is over budget either way: the same mode.
    e = plan((768, 768), torch.float32, backend="cuda")
    assert e.config.dispatch_mode == "wavefront"


def test_c7_entry_that_measured_both_modes_decides():
    timings = {"tiled[b32,wavefront]": 900.0,
               "tiled[b32,megakernel]": 950.0, "geqrf_ht": 1500.0}
    set_active_cache(TuningCache([_edge_entry("cuda", timings)]))
    s = plan((640, 640), torch.float32, backend="cuda", explain=True)
    assert s.config.dispatch_mode == "wavefront"
    assert "dispatch_mode=wavefront" in s.explain.decision(
        "tuned_config").reason
    assert plan((640, 640), torch.float32,
                QRConfig(dispatch_mode="megakernel"),
                backend="cuda").config.dispatch_mode == "megakernel"


def test_tuned_kernel_pick_on_cuda_runs_the_kernels():
    """A measured kernel pick resolves ``use_kernel`` as the sweep ran
    it.  On the card a kernel-backed pick measured on its plain lowering
    is unfit (the plan never moves the card's work off the kernels
    unasked): ``tuned`` is rejected with the reason and the heuristic
    routes, on the kernels; ``use_kernel=False`` asks for the plain
    lowering and then the entry applies."""
    set_active_cache(TuningCache([
        _entry(m=256, n=256, method="geqrf_ht", block=32, backend="cuda",
               use_kernel=True),
        _entry(m=384, n=384, method="tiled", block=64, backend="cuda",
               use_kernel=False)]))
    s = plan((256, 256), torch.float32, backend="cuda", explain=True)
    assert (s.config.method, s.config.use_kernel) == ("geqrf_ht", True)
    s = plan((300, 300), torch.float32, backend="cuda", explain=True)
    d = s.explain.decision("tuned")
    assert d.outcome == "rejected" and "plain lowering" in d.reason
    assert s.explain.selected.rule != "tuned" and s.config.use_kernel
    assert (s.config.method, s.config.use_kernel) == (
        plan((300, 300), torch.float32, QRConfig(use_tuning_cache=False),
             backend="cuda").config.method, True)
    s = plan((300, 300), torch.float32, QRConfig(use_kernel=False),
             backend="cuda", explain=True)
    assert s.explain.selected.rule == "tuned"
    assert (s.config.method, s.config.block, s.config.use_kernel) == (
        "tiled", 64, False)


# ------------------------------------------------- the reference's tests

def test_cache_miss_and_use_tuning_cache_false():
    set_active_cache(TuningCache(source="test-empty"))
    s = plan((300, 280), torch.float32, backend="cpu", explain=True)
    assert s.config.method == "geqrf_ht"
    assert s.explain.decision("tuned").outcome == "rejected"
    assert plan((4096, 32), torch.float32, backend="cpu").config.method == "tsqr"
    _both_defaults()
    s = plan((512, 512), torch.float32, QRConfig(use_tuning_cache=False),
             backend="cpu", explain=True)
    assert s.config.method == "tiled"
    d = s.explain.decision("tuned")
    assert d.outcome == "rejected" and "use_tuning_cache=False" in d.reason
    d = plan((512, 512), torch.float32, backend="cuda",
             explain=True).explain.decision("tuned")
    assert d.outcome == "rejected" and "cache miss" in d.reason


def test_overlay_respects_explicit_knobs():
    set_active_cache(TuningCache([_entry(method="tiled", block=64)]))
    s = plan((2048, 2048), torch.float32, backend="cpu", explain=True)
    assert (s.config.method, s.config.block) == ("tiled", 64)
    assert s.explain.decision("tuned_config").outcome == "resolved"
    assert plan((2048, 2048), torch.float32, QRConfig(block=48),
                backend="cpu").config.block == 48
    s = plan((2048, 2048), torch.float32, QRConfig(method="geqrf"),
             backend="cpu", explain=True)
    assert s.config.method == "geqrf" and s.explain.selected.rule == "explicit"


def test_unfit_tuned_method_is_rejected():
    set_active_cache(TuningCache([_entry(method="not_a_method")]))
    s = plan((2048, 2048), torch.float32, backend="cpu", explain=True)
    assert s.config.method == "tiled"
    assert s.explain.decision("tuned").outcome == "rejected"


def test_tuned_solver_matches_the_plain_answer():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    _both_defaults()
    import repro_torch

    q, r = repro_torch.qr(a, device="cpu")
    rn = torch.linalg.qr(a.double())[1]
    s = torch.sign(torch.diagonal(r)).double() * torch.sign(torch.diagonal(rn))
    assert float((r.double() * s[:, None] - rn).abs().max()) <= 2e-3
    assert float((q @ r - a).abs().max()) <= 1e-4


# ---------------------------------------------------------- the gate

def test_check_cache_gate():
    fresh = TuningCache([_entry(best_us=100.0, heuristic_us=150.0)])
    assert sweep.check_cache(fresh) == [] == sweep.check_cache(fresh, fresh)
    slow = TuningCache([_entry(best_us=200.0, heuristic_us=100.0)])
    (p,) = sweep.check_cache(slow)
    assert "slower than heuristic" in p
    base = TuningCache([_entry(best_us=10.0, heuristic_us=20.0)])
    drift = TuningCache([_entry(best_us=100.0, heuristic_us=200.0)])
    (p,) = sweep.check_cache(drift, base, drift_tol=5.0)
    assert "regressed" in p
    assert sweep.check_cache(drift, base, drift_tol=20.0) == []


# ---------------------------------------------------- the sweep's candidates

@pytest.mark.parametrize("shape", sweep.DEFAULT_SHAPES)
def test_cuda_candidates_measure_the_heuristic_once(shape):
    """On "cuda" ``use_kernel=None`` resolves to the kernels, so the
    heuristic pick dedups against its grid candidate; the tiled
    candidates are the kernels' — the wavefront lowering per block and
    the megakernel where the engine's budget rule admits it — not the
    plain lowering, which the CPU sweep times."""
    from repro_torch.core import engine
    from repro_torch.core.tilegraph import tile_grid

    m, n = shape
    labels = [lb for lb, _ in sweep.candidates(m, n, torch.float32, "cuda")]
    assert not any(lb.startswith("heuristic:") for lb in labels), labels
    want = {"geqrf", "geqrf_ht"} | ({"geqr2_ht"} if min(m, n) <= 128 else set())
    for b in (32, 64):
        if min(m, n) >= 2 * b:
            want.add(f"tiled[b{b},wavefront]")
            p, q = tile_grid(m, n, b)
            if engine.resolve_dispatch_mode(p, q, b) == "megakernel":
                want.add(f"tiled[b{b},megakernel]")
    assert set(labels) == want
    heur = sweep._heuristic_config(m, n, torch.float32, "cuda")
    assert heur.use_kernel is True


@pytest.mark.parametrize("shape", [(64, 64), (256, 256), (512, 512),
                                   (200, 120)])
def test_cpu_candidates_equal_reference(shape):
    from repro.tuning import sweep as jsweep

    m, n = shape
    mine = [lb for lb, _ in sweep.candidates(m, n, torch.float32, "cpu")]
    ref = [lb for lb, _ in jsweep.candidates(m, n, jnp.float32, "cpu")]
    assert mine == ref
    for (lb, c), (_, jc) in zip(sweep.candidates(m, n, torch.float32, "cpu"),
                                jsweep.candidates(m, n, jnp.float32, "cpu")):
        assert sweep._cand_key(c, "cpu") == jsweep._cand_key(jc), lb


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(1.0, abs(b))


def test_modeled_bound_uses_the_ports_roofline():
    from repro_torch.core import engine
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, qr_flops

    cfg = QRConfig(method="tiled", block=32, use_kernel=True,
                   dispatch_mode="megakernel")
    dma = engine.modeled_dma_bytes(20, 20, 32, 4)["megakernel"]
    want = 1e6 * max(qr_flops(640, 640) / PEAK_FLOPS["float32"],
                     dma / HBM_BW)
    assert _close(sweep.modeled_bound_us(cfg, 640, 640, torch.float32), want)


def test_measure_candidate_skips_only_planning_errors(monkeypatch):
    a = torch.zeros((64, 64))
    bad = QRConfig(method="tsqr", mode="r", use_tuning_cache=False)
    assert sweep.measure_candidate(bad, a, 1) is None     # not tall-skinny

    def fail(*args, **kwargs):
        raise RuntimeError("kernel fault")

    import importlib

    tplan = importlib.import_module("repro_torch.core.plan")
    spec = tplan.get_method("geqrf_ht")
    monkeypatch.setitem(tplan._REGISTRY, "geqrf_ht",
                        tplan.dataclasses.replace(spec, factor=fail))
    with pytest.raises(RuntimeError, match="kernel fault"):
        sweep.measure_candidate(QRConfig(method="geqrf_ht", mode="r"), a, 1)


def test_sweep_small_shape_end_to_end(tmp_path):
    """A real (tiny) CPU sweep: it measures the candidates, records the
    heuristic pick, emits the tuning metrics, passes its gate, loads in
    the reference, and the planner selects what it wrote."""
    sweeps0 = metrics.counter_value("tuning.sweeps", backend="cpu")
    measured0 = metrics.counter_value("tuning.candidates", status="measured")
    cache = sweep.sweep_shapes([(64, 64)], reps=1, device="cpu")
    (e,) = cache.entries()
    assert e.shape_class == (64, 64) and e.backend == e.device_kind == "cpu"
    assert np.isfinite(e.heuristic_us)
    assert e.heuristic_method in e.timings_dict
    assert set(e.timings_dict) == {"geqrf", "geqrf_ht", "geqr2_ht",
                                   "tiled[b32]"}
    assert e.provenance_dict["generated_by"] == "repro_torch.tuning.sweep"
    assert metrics.counter_value("tuning.sweeps", backend="cpu") == sweeps0 + 1
    assert metrics.counter_value("tuning.candidates",
                                 status="measured") == measured0 + 4
    assert sweep.check_cache(cache) == []
    path = str(tmp_path / "swept.json")
    cache.save(path)
    assert len(jcache.TuningCache.load(path)) == 1
    set_active_cache(TuningCache.load(path))
    s = plan((64, 64), torch.float32, backend="cpu", explain=True)
    assert s.explain.selected.rule == "tuned"
    assert s.config.method == e.best.method


def test_sweep_cli_writes_and_checks(tmp_path):
    out = str(tmp_path / "cli.json")
    assert sweep.main(["--out", out, "--shapes", "64x64", "--reps", "1",
                       "--device", "cpu", "--check",
                       "--baseline", str(tmp_path / "none.json")]) == 0
    assert len(TuningCache.load(out)) == 1
