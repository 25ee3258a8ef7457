"""Quickstart: the MHT QR library of the port in five minutes.

    python -m repro_torch.examples.quickstart [--device cpu]

Twin of the reference's ``examples/quickstart.py``.  Factorizations are
*planned*: a hashable ``QRConfig`` names what you want (or
``method="auto"`` lets the planner route by shape and device),
``plan()`` resolves it against the method registry, and the returned
``QRSolver`` does the work — batched, and on "cuda" through the
hand-written kernels.
"""

import argparse

import numpy as np
import torch

from repro_torch import QRConfig, lstsq, orthogonalize, plan, qr
from repro_torch.core.dag import phase_model_theta
from repro_torch.core.plan import available_methods, get_method


def _rec(q, r, a):
    return float(torch.linalg.matrix_norm(q @ r - a)
                 / torch.linalg.matrix_norm(a))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = {}
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((512, 128)), dtype=torch.float32,
                     device=dev)

    # 1. every realization the paper discusses, via the method registry
    for method in available_methods():
        if method in ("geqrf_fori", "degenerate"):
            continue  # optimizer-internal (padded shapes); zero-dim route
        q, r = qr(a, config=QRConfig(method=method), device=dev)
        orth = float(torch.linalg.matrix_norm(
            q.T @ q - torch.eye(q.shape[1], device=dev)))
        out[method] = _rec(q, r, a)
        print(f"{method:13s} reconstruction={out[method]:.2e} "
              f"orthogonality={orth:.2e}   [{get_method(method).description}]")
        assert out[method] < 1e-5 and orth < 1e-4, (method, out[method], orth)

    # 2. method="auto": the planner routes by shape and device
    for shape in [(1024, 32), (512, 512), (512, 128), (24, 16)]:
        solver = plan(shape, torch.float32, QRConfig(), backend=dev.type)
        print(f"auto {shape}: -> {solver.config.method}"
              f" (use_kernel={solver.config.use_kernel},"
              f" dispatch_mode={solver.config.dispatch_mode})")

    # 2b. the tiled task graph: GEQRT/TSQRT/LARFB/SSRFB tile tasks,
    #     levelized; one launch a (level, kind) or one megakernel launch
    from repro_torch.core import dag, schedule_stats, wavefront_count

    qt, rt = qr(a, config=QRConfig(method="tiled", block=32,
                                   use_kernel=False), device=dev)
    print(f"{'tiled':13s} reconstruction={_rec(qt, rt, a):.2e} "
          f"wavefronts={wavefront_count(512 // 32, 128 // 32)} "
          f"(vs 128 sequential columns unblocked)")
    beta_gain = dag.analyze_tiled(128, 16).beta / dag.analyze_mht(128).beta
    print(f"tiled ops/DAG-level vs MHT at n=128: {beta_gain:.0f}x")
    for mode in ("wavefront", "megakernel"):
        qm, rm = qr(a, config=QRConfig(method="tiled", block=32,
                                       use_kernel=True, dispatch_mode=mode),
                    device=dev)
        print(f"{mode:13s} reconstruction={_rec(qm, rm, a):.2e} "
              f"max|Q - Q_plain|={float((qm - qt).abs().max()):.2e}")
    stats = schedule_stats(512 // 32, 128 // 32, nb=32)
    print(f"{'schedule':13s} dispatches {stats['wavefront']['dispatches']} "
          f"-> {stats['megakernel']['dispatches']}, table "
          f"{stats['megakernel']['table_bytes']} B, auto={stats['auto']}")

    # 2c. the sharded tiled backend: without a process group it is the
    #     tiled backend bit for bit (ranks: python -m torch.distributed)
    from repro_torch.core import sharded_wavefront_count

    big = torch.tensor(rng.standard_normal((512, 512)), dtype=torch.float32,
                       device=dev)
    qs, rs = qr(big, config=QRConfig(method="sharded_tiled", block=64),
                device=dev)
    print(f"{'sharded':13s} reconstruction={_rec(qs, rs, big):.2e} "
          f"wavefronts at d=4: {sharded_wavefront_count(8, 8, 4)} "
          f"(vs {8 + 2 * 8 - 2} on one device)")

    # 3. the kernel-backed blocked MHT
    q, r = qr(a, config=QRConfig(method="geqrf_ht", use_kernel=True,
                                 block=32), device=dev)
    print(f"{'kernels':13s} reconstruction={_rec(q, r, a):.2e}")

    # 4. batched QR: leading dims go through the same solver
    stack = torch.tensor(rng.standard_normal((4, 64, 32)),
                         dtype=torch.float32, device=dev)
    qs, rs = qr(stack, config=QRConfig(method="geqrf_ht", block=16),
                device=dev)
    print("batched:", tuple(qs.shape), tuple(rs.shape))

    # 4b. QR as a service: requests bucket by shape, each bucket padded,
    #     stacked and factored in one dispatch, plans cached
    from repro_torch.serving import BucketingPolicy, QRService

    service = QRService(policy=BucketingPolicy(tile=16, max_batch=8),
                        use_kernel=False, device=dev)
    mix = [rng.standard_normal(s).astype(np.float32)
           for s in [(48, 48), (45, 41), (96, 32), (48, 48), (37, 23)]]
    results = service.submit_many(mix)
    worst = max(_rec(res.q, res.r, torch.as_tensor(a_i, device=dev))
                for a_i, res in zip(mix, results))
    service.submit_many(mix)                 # warm cache: no new plans
    s = service.stats()
    print(f"{'serving':13s} requests={s['requests']} "
          f"dispatches={s['dispatches']} compiles={s['compiles']} "
          f"cache_hit_rate={s['cache_hit_rate']:.2f} "
          f"fill={s['bucket_fill_ratio']:.2f} worst_rec={worst:.2e}")

    # 4b'. robustness: a poisoned request is quarantined, the rest served
    from repro_torch.robustness import inject

    hardened = QRService(policy=BucketingPolicy(tile=16, max_batch=8),
                         use_kernel=False, verify=True, device=dev)
    poisoned = list(mix)
    poisoned[1] = inject.poison(poisoned[1], kind="nan")
    hres = hardened.submit_many(poisoned)
    hs = hardened.stats()
    print(f"{'robust':13s} poisoned request -> {hres[1].error} "
          f"(clean {sum(r.ok for r in hres)}/{len(hres)}, "
          f"quarantined={hs['quarantined']}, "
          f"escalations={hs['escalations']})")
    assert hres[1].error and all(r.ok for i, r in enumerate(hres) if i != 1)

    # 4c. observability: the planner's explain trail and the span tracer
    from repro_torch import observability as obs

    explained = plan((512, 512), torch.float32, QRConfig(),
                     backend=dev.type, explain=True)
    print(f"{'explain':13s} method={explained.config.method} "
          f"<- {explained.explain.selected.rule}: "
          f"{explained.explain.selected.reason}")
    with obs.enabled_scope():
        service.submit_many(mix)
    print(f"{'tracing':13s} {len(obs.spans())} spans; "
          f"obs.export_chrome_trace('trace.json') renders in "
          f"chrome://tracing, `python -m repro_torch.observability.report "
          f"--capture DIR` bundles trace + metrics")
    obs.trace.clear()

    # 5. the optimizer primitive: orthogonalize a momentum matrix
    o = orthogonalize(torch.tensor(rng.standard_normal((256, 64)),
                                   dtype=torch.float32, device=dev),
                      config=QRConfig(), device=dev)
    out["orthogonalize"] = float(torch.linalg.matrix_norm(
        o.T @ o - torch.eye(64, device=dev)))
    print("orthogonalize:", tuple(o.shape), out["orthogonalize"])

    # 5b. batched optimizer-step orthogonalization: one planned dispatch
    #     per shape class (muon_update(batched_ortho=True) rides on it)
    from repro_torch.optim import plan_batched_ortho

    step_shapes = [((3, 48, 48), torch.float32)] * 4 + \
        [((3, 96, 48), torch.float32), ((3, 48, 96), torch.float32),
         ((40, 24), torch.float32)]
    oplan = plan_batched_ortho(step_shapes, backend=dev.type)
    print(f"{'batched':13s} {oplan.n_matrices} matrices / "
          f"{oplan.n_leaves} leaves -> {oplan.dispatches} dispatches "
          f"({len(oplan.classes)} shape classes)")
    for cls in oplan.classes:
        trail = (f"{cls.method} <- {cls.explain.selected.rule}"
                 if cls.route == "batched" else cls.reason.split(":")[0])
        print(f"{'':13s} class {cls.key.m}x{cls.key.n} "
              f"b={len(cls.members)}: {cls.route} ({trail})")

    # 6. least squares (the Kalman filter's building block, paper §1)
    x = lstsq(a, a @ torch.ones(128, device=dev), config=QRConfig(),
              device=dev)
    out["lstsq"] = float(torch.linalg.vector_norm(x - 1.0))
    print("lstsq residual:", out["lstsq"])
    assert out["lstsq"] < 1e-3

    # 7. the paper's parallelism claim (fig 9)
    out["theta"] = phase_model_theta(512)["theta"]
    print("theta (4-wide RDP model, n=512):", round(out["theta"], 4),
          "~ paper 0.749")
    return out


if __name__ == "__main__":
    main()
