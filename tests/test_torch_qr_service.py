"""The port's QR service (``repro_torch.serving``) against the reference's
(``repro.serving``): bucketing properties on the port's copy, service
correctness, and prepared-plan cache behavior, on the CPU.

Each test twins one of tests/test_qr_service.py; the tuning-cache tests
(a new cache drops the plans, a measured entry sets a bucket's rung) run
the port's own ``repro_torch.tuning``.  The card-only service checks are
in tests/test_torch_cuda.py.

Comparison with the reference: the same seeded request stream goes
through ``repro.serving.QRService`` (its jnp oracle) and the port's
service (``device="cpu"``, the plain lowering); the answers agree within
10·eps·max(m, n)·max(1, max |ref|), and the bucket keys, the plan keys
and the ``stats()`` counters (plan builds against compiles, hits,
dispatches, padded slots, fill) are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hypothesis_compat import given, st
from repro import serving as jserving
from repro_torch.serving import (
    BucketKey, BucketingPolicy, QRService, bucket_key, bucketize, pad_batch,
    pad_dim, pow2ish_edges)
from worker_threads import share_the_cores  # noqa: F401  (autouse)

# ------------------------------------------------------------- bucketing


@given(tile=st.sampled_from([8, 16, 32, 64]), d=st.integers(1, 5000),
       waste=st.floats(0.05, 0.5))
def test_pad_dim_properties(tile, d, waste):
    """The reference's property on the port's copy: a tile multiple >=
    max(d, tile), a pow2-ish edge within the cap or the tile fallback,
    the cap honored whenever tile granularity can honor it — and the
    reference's value."""
    e = pad_dim(d, tile=tile, max_waste=waste)
    assert e >= d and e >= tile and e % tile == 0
    tiled_up = -(-d // tile) * tile
    assert e == tiled_up or ((e - d) / e <= waste
                             and e in pow2ish_edges(tile, d))
    if (tiled_up - d) / tiled_up <= waste:
        assert (e - d) / e <= waste
    assert e == jserving.pad_dim(d, tile=tile, max_waste=waste)


def test_pad_dim_monotone():
    for tile, waste in [(16, 0.25), (32, 0.25), (8, 0.1)]:
        pads = [pad_dim(d, tile=tile, max_waste=waste)
                for d in range(1, 700)]
        assert all(a <= b for a, b in zip(pads, pads[1:]))


def test_pow2ish_edges_ladder():
    assert pow2ish_edges(32, 200) == (32, 64, 96, 128, 192, 256)
    edges = pow2ish_edges(16, 10000)
    ratios = [b / a for a, b in zip(edges[2:], edges[3:])]
    assert max(ratios) <= 1.5


def test_pad_batch_pow2_capped():
    assert [pad_batch(b, max_batch=8) for b in (1, 2, 3, 4, 5, 8, 9, 100)] \
        == [1, 2, 4, 4, 8, 8, 8, 8]
    with pytest.raises(ValueError):
        pad_batch(0, max_batch=8)


def test_policy_and_key_validation():
    with pytest.raises(ValueError):
        BucketingPolicy(tile=0)
    with pytest.raises(ValueError):
        BucketingPolicy(max_waste=1.0)
    with pytest.raises(ValueError):
        BucketKey(m=32, n=32, dtype="float32", mode="full")


def test_default_policy_pads_smollm_projections():
    """The planning facts the card's service phase relies on: 576 pads
    to 768 (waste exactly 0.25, the cap is strict), 192 stays, and the
    serving mix's shapes land where the reference puts them."""
    pol = BucketingPolicy()
    assert pad_dim(576, tile=32, max_waste=0.25) == 768
    assert bucket_key(576, 192, "float32", "reduced", pol) == BucketKey(
        768, 192, "float32", "reduced")
    mix = [(128, 128), (120, 110), (96, 64), (64, 64), (130, 120)]
    assert [(bucket_key(m, n, "float32", "r", pol).m,
             bucket_key(m, n, "float32", "r", pol).n) for m, n in mix] == \
        [(128, 128), (128, 128), (96, 64), (64, 64), (160, 128)]


@dataclasses.dataclass
class _Req:
    shape: tuple
    dtype: str
    mode: str


@given(seed=st.integers(0, 10_000), nreq=st.integers(1, 40))
def test_every_request_lands_in_exactly_one_bucket(seed, nreq):
    """bucketize partitions the request stream exactly as the
    reference's does."""
    rng = np.random.default_rng(seed)
    policy = BucketingPolicy(tile=16, max_waste=0.3, max_batch=8)
    reqs = [_Req(shape=(int(rng.integers(1, 400)), int(rng.integers(1, 400))),
                 dtype=str(rng.choice(["float32", "float64"])),
                 mode=str(rng.choice(["reduced", "r"])))
            for _ in range(nreq)]
    buckets = bucketize(reqs, policy)
    seen = []
    for key, members in buckets.items():
        for r in members:
            assert bucket_key(*r.shape, r.dtype, r.mode, policy) == key
            assert key.m >= r.shape[0] and key.n >= r.shape[1]
            seen.append(id(r))
    assert sorted(seen) == sorted(id(r) for r in reqs)
    ref = jserving.bucketize(reqs, jserving.BucketingPolicy(
        tile=16, max_waste=0.3, max_batch=8))
    assert [dataclasses.astuple(k) for k in buckets] == \
        [dataclasses.astuple(k) for k in ref]
    assert [[id(r) for r in v] for v in buckets.values()] == \
        [[id(r) for r in v] for v in ref.values()]


# ------------------------------------------------------------ the service


def _check_qr(a, q, r, tol=2e-4):
    m, n = a.shape
    k = min(m, n)
    q, r = np.asarray(q), np.asarray(r)
    assert q.shape == (m, k) and r.shape == (k, n)
    assert np.abs(q @ r - a).max() <= tol
    assert np.abs(q.T @ q - np.eye(k, dtype=a.dtype)).max() <= tol
    assert np.abs(np.tril(r[:, :k], -1)).max() == 0.0


@pytest.fixture
def service():
    return QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                     device="cpu")


def test_default_device_is_cuda(monkeypatch):
    """Without ``device`` the service runs on the card, and without a card
    it raises; it never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QRService()
    svc = QRService(device="cpu")
    assert svc.device.type == "cpu" and svc.use_kernel is False


def test_heterogeneous_mix_reduced(service):
    rng = np.random.default_rng(0)
    shapes = [(48, 48), (96, 32), (20, 50), (37, 23), (48, 48), (45, 45)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    results = service.submit_many(arrs)
    assert len(results) == len(arrs)
    for a, res in zip(arrs, results):
        _check_qr(a, res.q, res.r)
        assert res.q.device.type == "cpu"
    stats = service.stats()
    assert stats["matrices_served"] == len(arrs)
    assert stats["requests"] == len(arrs)
    assert stats["dispatches"] >= 1


def test_r_mode(service):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal((40, 24)).astype(np.float32)
            for _ in range(3)]
    results = service.submit_many(arrs, mode="r")
    for a, res in zip(arrs, results):
        assert res.q is None
        r = np.asarray(res.r)
        assert r.shape == (24, 24)
        assert np.abs(np.tril(r, -1)).max() == 0.0
        assert np.abs(r.T @ r - a.T @ a).max() <= 2e-3 * np.abs(a.T @ a).max()


def test_submit_flush_rids(service):
    rng = np.random.default_rng(2)
    a, b = (rng.standard_normal((32, 32)).astype(np.float32)
            for _ in range(2))
    ra = service.submit(a)
    rb = service.submit(torch.from_numpy(b), mode="r")   # a tensor payload
    out = service.flush()
    assert set(out) == {ra, rb}
    _check_qr(a, out[ra].q, out[ra].r)
    assert out[rb].q is None
    assert service.flush() == {}


def test_ragged_bucket_padding(service):
    rng = np.random.default_rng(3)
    shapes = [(64, 48), (60, 40), (57, 33)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    results = service.submit_many(arrs)
    for a, res in zip(arrs, results):
        _check_qr(a, res.q, res.r)
    stats = service.stats()
    assert stats["dispatches"] == 1, "one bucket must mean one dispatch"
    assert stats["padded_slots"] == 1
    assert stats["bucket_fill_ratio"] == pytest.approx(3 / 4)


def test_max_batch_chunking(service):
    """A bucket larger than max_batch splits into chunks; two chunks of
    one plan share its staging buffer without mixing their inputs."""
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((32, 32)).astype(np.float32)
            for _ in range(6)]
    results = service.submit_many(arrs)
    for a, res in zip(arrs, results):
        _check_qr(a, res.q, res.r)
    assert service.stats()["dispatches"] == 2
    assert service.stats()["padded_slots"] == 0
    arrs = [rng.standard_normal((30, 31)).astype(np.float32)
            for _ in range(8)]                   # two chunks, one plan
    verified = QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                         device="cpu", verify=True)
    for a, res in zip(arrs, verified.submit_many(arrs)):
        _check_qr(a, res.q, res.r)
    assert verified.stats()["compiles"] == 1
    assert verified.stats()["health_check_failures"] == 0


def test_device_tensors_stay_on_the_device():
    """A tensor on the service's device is admitted there and taken into
    its bucket by a device copy: no staging buffer is made for a stream
    of them, a NaN tensor is quarantined, and the answers are bitwise
    those of the same payloads submitted as host arrays."""
    rng = np.random.default_rng(6)
    shapes = [(48, 48), (40, 30), (48, 48)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    policy = BucketingPolicy(tile=16, max_batch=4)
    host = QRService(policy=policy, device="cpu").submit_many(arrs)
    svc = QRService(policy=policy, device="cpu")
    tensors = [torch.from_numpy(a) for a in arrs]
    got = svc.submit_many(tensors)
    assert all(plan.staging is None for plan in svc._plans.values())
    for h, g in zip(host, got):
        assert torch.equal(h.q, g.q) and torch.equal(h.r, g.r)
    mixed = svc.submit_many([tensors[0], arrs[1], tensors[2]])
    for h, g in zip(host, mixed):
        assert torch.equal(h.q, g.q) and torch.equal(h.r, g.r)
    bad = tensors[0].clone()
    bad[3, 4] = float("nan")
    rid = svc.submit(bad)
    assert svc.flush()[rid].error == "quarantined:nonfinite_input"


def test_padded_slots_skip_the_slice_by_slice_rungs():
    """On the wavefront rung a padded batch factors only its filled
    slices (``engine.stacked_wavefront_slices`` counts them; the stack
    takes one schedule's launches), with the answers of the whole padded
    stack bit for bit."""
    from repro_torch.core import engine, tilegraph
    from repro_torch.observability import metrics

    g = torch.Generator().manual_seed(0)
    stack = torch.zeros(4, 32, 32)
    stack[:3] = torch.randn(3, 32, 32, generator=g)
    whole = tilegraph._factor_stack_padded(
        stack.clone(), p=4, q=4, nb=8, mode="reduced", use_kernel=True,
        dispatch_mode="wavefront")
    metrics.reset()
    part = tilegraph._factor_stack_padded(
        stack.clone(), p=4, q=4, nb=8, mode="reduced", use_kernel=True,
        dispatch_mode="wavefront", filled=3)
    assert all(torch.equal(x, y) for x, y in zip(whole, part))
    per_call = sum(engine.dispatch_counts(4, 4, "wavefront", 3).values())
    assert metrics.counter_value("engine.dispatches", mode="wavefront",
                                 phase="execute") == per_call
    for stage in ("factor", "q"):
        assert metrics.counter_value("engine.stacked_wavefront_slices",
                                     stage=stage) == 3
    svc = QRService(policy=BucketingPolicy(tile=8, max_batch=4),
                    use_kernel=True, dispatch_mode="wavefront", device="cpu")
    metrics.reset()
    arrs = [stack[i].numpy() for i in range(3)]
    for a, res in zip(arrs, svc.submit_many(arrs)):
        _check_qr(a, res.q, res.r)
    assert metrics.counter_value("engine.dispatches", mode="wavefront",
                                 phase="execute") == per_call
    assert metrics.counter_value("engine.stacked_wavefront_slices",
                                 stage="factor") == 3
    assert svc.stats()["padded_slots"] == 1


def test_kernel_megakernel_serving_path():
    """The kernel path of the service on the CPU (the megakernel
    wrappers' plain walks): one bucket, one batched megakernel dispatch,
    the same numerical bar."""
    rng = np.random.default_rng(5)
    svc = QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                    use_kernel=True, dispatch_mode="megakernel",
                    device="cpu")
    arrs = [rng.standard_normal((48, 32)).astype(np.float32)
            for _ in range(2)]
    for a, res in zip(arrs, svc.submit_many(arrs)):
        _check_qr(a, res.q, res.r)
    assert svc.stats()["dispatches"] == 1
    ((key, batch, rung),) = svc._plans
    assert (key.m, key.n, batch, rung) == (48, 32, 2, "megakernel")


def test_kernel_auto_rung_follows_the_engine_rule():
    """With ``dispatch_mode=None`` a bucket's rung is the engine's auto
    rule: the megakernel where its table fits, the wavefront lowering
    past it (a 768² bucket at tile 32)."""
    svc = QRService(use_kernel=True, device="cpu")
    assert svc._initial_rung(BucketKey(128, 128, "float32", "r")) == \
        "megakernel"
    assert svc._initial_rung(BucketKey(768, 192, "float32", "r")) == \
        "megakernel"
    assert svc._initial_rung(BucketKey(768, 768, "float32", "r")) == \
        "wavefront"
    rng = np.random.default_rng(12)
    arrs = [rng.standard_normal((40, 20)).astype(np.float32)
            for _ in range(2)]
    wave = QRService(policy=BucketingPolicy(tile=8, max_batch=2),
                     use_kernel=True, dispatch_mode="wavefront",
                     device="cpu", verify=True)
    for a, res in zip(arrs, wave.submit_many(arrs)):
        _check_qr(a, res.q, res.r)
    assert wave.stats()["escalations"] == 0


def test_submit_validation(service):
    with pytest.raises(ValueError):
        service.submit(np.zeros((3, 3, 3), np.float32))
    with pytest.raises(ValueError):
        service.submit(np.zeros((3, 3), np.float32), mode="full")
    with pytest.raises(ValueError):
        QRService(cache_size=0, device="cpu")


# ------------------------------------------------------------- plan cache


def test_zero_recompiles_steady_state(service, monkeypatch):
    """Once the cache is warm, repeated traffic with the same shape mix
    builds no plan and uploads no schedule table."""
    rng = np.random.default_rng(6)
    shapes = [(48, 48), (96, 32), (37, 23)]

    def mix():
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]

    service.submit_many(mix())
    warm = service.stats()["compiles"]
    assert warm > 0
    from repro_torch.core import engine
    monkeypatch.setattr(engine, "prepare_dispatch",
                        lambda *a, **k: pytest.fail("plan rebuilt"))
    for _ in range(3):
        arrs = mix()
        for a, res in zip(arrs, service.submit_many(arrs)):
            _check_qr(a, res.q, res.r)
    stats = service.stats()
    assert stats["compiles"] == warm, \
        f"steady-state rebuild: {stats['compiles']} != {warm}"
    assert stats["cache_hits"] >= 3 * len(shapes)
    assert stats["cache_hit_rate"] > 0.5


def test_zero_uploads_steady_state_on_the_kernel_path():
    """The kernel path prepares its device tables at plan build: a warm
    stream leaves the engine's device caches unchanged."""
    from repro_torch.core import engine
    rng = np.random.default_rng(13)
    svc = QRService(policy=BucketingPolicy(tile=8, max_batch=2),
                    use_kernel=True, device="cpu")
    shapes = [(16, 16), (24, 8)]
    svc.submit_many([rng.standard_normal(s).astype(np.float32)
                     for s in shapes])
    caches = (engine._DEVICE_INDEX, engine._DEVICE_TABLE)
    before = [set(c) for c in caches]
    for _ in range(2):
        svc.submit_many([rng.standard_normal(s).astype(np.float32)
                         for s in shapes])
    assert [set(c) for c in caches] == before
    assert svc.stats()["compiles"] == 2


def test_plan_cache_lru_eviction():
    rng = np.random.default_rng(7)
    svc = QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                    device="cpu", cache_size=2)

    def go(shape):
        svc.submit_many([rng.standard_normal(shape).astype(np.float32)])

    go((32, 32))
    go((64, 32))
    go((32, 32))
    go((96, 32))
    s = svc.stats()
    assert (s["compiles"], s["cache_hits"], s["cache_evictions"]) == (3, 1, 1)
    assert s["plans_cached"] == 2
    go((32, 32))
    assert svc.stats()["cache_hits"] == 2
    go((64, 32))
    s = svc.stats()
    assert s["compiles"] == 4 and s["cache_evictions"] == 2


# ------------------------------------------------------ against the reference

_STATS_KEYS = ("requests", "matrices_served", "dispatches", "compiles",
               "cache_hits", "cache_misses", "cache_evictions",
               "plans_cached", "padded_slots", "bucket_fill_ratio",
               "cache_hit_rate", "quarantined", "escalations")


@pytest.mark.parametrize("mode", ["reduced", "r"])
def test_stream_matches_reference(mode):
    """One seeded heterogeneous stream, two waves (cold, then warm),
    through the reference's service and the port's: the same plan keys,
    counters and answers within 10·eps·max(m, n)·max(1, max |ref|)."""
    rng = np.random.default_rng(8)
    shapes = [(48, 48), (96, 32), (20, 50), (37, 23), (45, 45), (48, 48)]
    waves = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    mine = QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                     device="cpu")
    ref = jserving.QRService(policy=jserving.BucketingPolicy(
        tile=16, max_batch=4), use_kernel=False)
    eps = float(np.finfo(np.float32).eps)
    for wave in waves:
        got = mine.submit_many(wave, mode=mode)
        want = ref.submit_many(wave, mode=mode)
        for a, g, w in zip(wave, got, want):
            assert g.ok and w.ok
            for x, y in ((g.q, w.q), (g.r, w.r)):
                if y is None:
                    assert x is None
                    continue
                y = np.asarray(y)
                tol = 10 * eps * max(a.shape) * max(1.0,
                                                    float(np.abs(y).max()))
                assert x.shape == y.shape
                assert float(np.abs(x.numpy() - y).max()) <= tol
    mine_keys = [(dataclasses.astuple(k), b, rung)
                 for k, b, rung in mine._plans]
    assert mine_keys == [(dataclasses.astuple(k), b, rung)
                         for k, b, rung in ref._plans]
    s, t = mine.stats(), ref.stats()
    assert {k: s[k] for k in _STATS_KEYS} == {k: t[k] for k in _STATS_KEYS}


# ------------------------------------------------------------ tuning cache

def test_tuning_refresh_invalidates_plans():
    """A tuning-cache swap drops every resident bucket plan (a plan bakes
    in the rung the old cache chose), counting ``plan_invalidations``
    once; steady state under the new cache builds nothing — the
    reference's counters on the same stream."""
    from repro.tuning import cache as jcache
    from repro_torch.tuning import cache as tcache

    rng = np.random.default_rng(11)
    mine = QRService(policy=BucketingPolicy(tile=16, max_batch=4),
                     device="cpu")
    ref = jserving.QRService(policy=jserving.BucketingPolicy(
        tile=16, max_batch=4), use_kernel=False)
    keys = ("plan_invalidations", "compiles", "cache_evictions",
            "plans_cached")

    def go():
        a = rng.standard_normal((48, 48)).astype(np.float32)
        mine.submit_many([a])
        ref.submit_many([a])
        s, t = mine.stats(), ref.stats()
        assert {k: s[k] for k in keys} == {k: t[k] for k in keys}
        return s

    prev, jprev = tcache.active_cache(), jcache.active_cache()
    try:
        s = go()
        assert s["plans_cached"] > 0 and s["plan_invalidations"] == 0
        compiles = s["compiles"]
        assert go()["compiles"] == compiles      # same cache: no rebuild
        tcache.set_active_cache(tcache.TuningCache(source="test:refresh"))
        jcache.set_active_cache(jcache.TuningCache(source="test:refresh"))
        s = go()                                 # new fingerprint
        assert s["plan_invalidations"] == 1
        assert s["compiles"] == compiles + 1
        s = go()                                 # the new steady state
        assert s["plan_invalidations"] == 1
        assert s["compiles"] == compiles + 1
    finally:
        tcache.set_active_cache(prev)
        jcache.set_active_cache(jprev)


def _rung_entry(mode, timed_modes, backend="cpu", cls=(128, 128)):
    from repro_torch.tuning import TunedConfig, TuningEntry

    timings = tuple(sorted((f"tiled[b32,{m}]", 100.0 + i)
                           for i, m in enumerate(timed_modes)))
    return TuningEntry(
        backend=backend, device_kind=backend, shape_class=cls,
        dtype="float32",
        best=TunedConfig(method="tiled", block=32, dispatch_mode=mode,
                         use_kernel=True),
        best_us=100.0, heuristic_method="tiled", heuristic_us=101.0,
        timings=timings)


@pytest.mark.parametrize("timed,want", [
    (("wavefront", "megakernel"), "wavefront"),
    (("wavefront",), "megakernel"),
])
def test_kernel_rung_follows_a_measured_entry(timed, want):
    """A bucket's first rung follows the measured entry's dispatch mode
    where the entry timed both lowerings at the bucket's tile; an entry
    that timed one lowering (at its class edge) leaves the rung to the
    engine's budget rule, which gives a 4 x 4 grid the megakernel
    (ROADMAP C7).  Installing the cache drops the resident plans."""
    from repro_torch.tuning import TuningCache, set_active_cache

    svc = QRService(policy=BucketingPolicy(tile=32, max_batch=4),
                    use_kernel=True, device="cpu")
    key = bucket_key(128, 128, np.float32, "r", svc.policy)
    assert svc._initial_rung(key) == "megakernel"
    a = np.random.default_rng(3).standard_normal((120, 128)).astype(np.float32)
    svc.submit_many([a], mode="r")
    prev = set_active_cache(TuningCache([_rung_entry("wavefront", timed)]))
    try:
        assert svc._initial_rung(key) == want
        out = svc.submit_many([a], mode="r")[0]
        assert out.ok
        assert [rung for _, _, rung in svc._plans] == [want]
        assert svc.stats()["plan_invalidations"] == 1
    finally:
        set_active_cache(prev)
