"""repro_torch.tuning.sweep — measure candidate planner configs per shape
class on the device.

    PYTHONPATH=src python -m repro_torch.tuning.sweep --out cache.json --check
    PYTHONPATH=src python -m repro_torch.tuning.sweep --smoke --device cpu

Counterpart of the reference's ``repro.tuning.sweep``.  For each swept
shape class the sweep builds the candidate set (method x block x
dispatch_mode), prunes it structurally (capability guards, the engine's
task-table and shared-memory budgets via
:func:`repro_torch.core.engine.explain_dispatch_mode`) and against the
roofline model (:func:`repro_torch.launch.roofline.modeled_seconds` over
:func:`qr_flops` and :func:`repro_torch.core.engine.modeled_dma_bytes`:
a candidate whose modeled lower bound already loses by
:data:`PRUNE_FACTOR` x is never timed), times each on the device (one
warm-up solve, one more to warm the caches, then the minimum of ``reps``,
the device synchronized around each solve), and records a
:class:`repro_torch.tuning.cache.TuningEntry` whose best pick the
planner's ``"tuned"`` routing rule consults.

The kernel candidates — ``tiled[bB,wavefront]``, and
``tiled[bB,megakernel]`` where the engine's budget rule admits it — are
swept on ``"cuda"``, where the kernels run (the reference sweeps them on
its TPU only), in place of the tiled method's plain lowering
(``tiled[bB]``), which is swept off the card; ``geqrf_ht`` and
``geqr2_ht`` there run the panel kernels, as
:func:`repro_torch.core.plan.plan` resolves ``use_kernel`` on the card.
Only a planning ``ValueError`` skips a candidate; a kernel's failure
raises, so the sweep never hides a kernel.

The heuristic pick (``plan`` with the cache disabled) is always measured,
so "tuned is never slower than heuristic on swept shapes" is a same-run
comparison (``--check``); ``--baseline`` adds a drift gate against a
saved cache's recorded timings.  Sweeps time ``mode="r"`` (the
factorization; Q formation is mode-specific), recorded in the entry's
provenance.  The sweep emits ``tuning.*`` metrics and ``tuning.sweep`` /
``tuning.shape`` trace spans when observability is enabled.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace
from repro_torch.tuning.cache import (DEFAULT_CACHE_PATH, TunedConfig,
                                      TuningCache, TuningEntry, dtype_name,
                                      shape_class)

__all__ = [
    "DEFAULT_SHAPES",
    "SMOKE_SHAPES",
    "PRUNE_FACTOR",
    "candidates",
    "modeled_bound_us",
    "prune_candidates",
    "measure_candidate",
    "sweep_shapes",
    "check_cache",
    "main",
]

#: Shape classes of the card's sweep: squares around the port's
#: crossovers — the tiled floor at 256 (taken from the reference's TPU)
#: and the megakernel's table budget, which admits 640^2 (20 x 20 tiles)
#: but not its class edge 768^2 — plus 1536 x 768, the class of
#: SmolLM-135M's (1536, 576) momenta.
DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = (
    (128, 128), (192, 192), (256, 256), (384, 384), (512, 512),
    (768, 768), (1024, 1024), (1536, 768))

#: Reduced grid for a quick gate.
SMOKE_SHAPES: Tuple[Tuple[int, int], ...] = ((256, 256), (512, 512))

#: Candidates whose roofline lower bound already exceeds the best
#: candidate's bound by this factor are pruned unmeasured (the model
#: ranks asymptotics, not constant factors).
PRUNE_FACTOR = 32.0

_TILED_BLOCKS = (32, 64)


def _heuristic_config(m: int, n: int, dtype, backend: str):
    """The planner's pick with the tuning cache pinned off — the
    baseline every tuned pick is measured against."""
    from repro_torch.core.plan import QRConfig, plan

    solver = plan((m, n), dtype, QRConfig(mode="r", use_tuning_cache=False),
                  backend=backend)
    return solver.config


def _resolved_use_kernel(cfg, backend: str) -> bool:
    """``cfg.use_kernel`` as the planner resolves it on ``backend``."""
    from repro_torch.core.plan import default_use_kernel

    if cfg.use_kernel is not None:
        return bool(cfg.use_kernel)
    return default_use_kernel(cfg.method, backend)


def candidates(m: int, n: int, dtype, backend: str
               ) -> List[Tuple[str, "object"]]:
    """The ``(label, QRConfig)`` candidate grid for one shape class —
    structurally pruned (capability guards, engine budgets) but not yet
    roofline-pruned.  Always includes the heuristic pick."""
    from repro_torch.core import engine
    from repro_torch.core.plan import QRConfig, as_torch_dtype, available_methods
    from repro_torch.core.tilegraph import tile_grid

    reg = available_methods()
    base = dict(mode="r", use_tuning_cache=False)
    out: List[Tuple[str, QRConfig]] = []

    for meth in ("geqrf", "geqrf_ht"):
        if meth in reg:
            out.append((meth, QRConfig(method=meth, **base)))
    # Unblocked MHT is O(m n^2) with no blocking — only plausible when
    # the matrix is at most a few panels tall.
    if "geqr2_ht" in reg and min(m, n) <= 128:
        out.append(("geqr2_ht", QRConfig(method="geqr2_ht", **base)))
    if "tsqr" in reg and n >= 1 and m >= 4 * n:
        out.append(("tsqr", QRConfig(method="tsqr", **base)))
    if "tiled" in reg:
        itemsize = as_torch_dtype(dtype).itemsize
        for b in _TILED_BLOCKS:
            if min(m, n) < 2 * b:
                continue  # fewer than 2 tiles per side: no wavefront
            if backend != "cuda":
                out.append((f"tiled[b{b}]",
                            QRConfig(method="tiled", block=b,
                                     use_kernel=False, **base)))
                continue  # the kernels run on the card only
            # On the card the plain lowering of the tiled kernels is their
            # check, not a serving configuration (100-200x the kernels'
            # time, most of a sweep's), as interpret-mode kernels are off
            # the reference's TPU: only the kernel lowerings are timed.
            p, q = tile_grid(m, n, b)
            out.append((f"tiled[b{b},wavefront]",
                        QRConfig(method="tiled", block=b, use_kernel=True,
                                 dispatch_mode="wavefront", **base)))
            mode, _ = engine.explain_dispatch_mode(p, q, b, itemsize)
            if mode == "megakernel":  # budget-pruned otherwise
                out.append((f"tiled[b{b},megakernel]",
                            QRConfig(method="tiled", block=b,
                                     use_kernel=True,
                                     dispatch_mode="megakernel", **base)))

    heur = _heuristic_config(m, n, dtype, backend)
    if not any(_cand_key(cfg, backend) == _cand_key(heur, backend)
               for _, cfg in out):
        out.append((f"heuristic:{heur.method}", heur))
    return out


def _cand_key(cfg, backend: str) -> Tuple:
    """Dedup key: the knobs that change what actually runs, with
    ``use_kernel=None`` as the planner resolves it on ``backend`` (the
    kernels on "cuda"), so the heuristic pick dedups against the
    equivalent grid candidate instead of being measured twice."""
    return (cfg.method, cfg.block, _resolved_use_kernel(cfg, backend),
            cfg.dispatch_mode, cfg.q_method)


def modeled_bound_us(cfg, m: int, n: int, dtype) -> float:
    """Roofline lower bound (us) on one solve: max(compute, HBM) time
    from the analytic QR flop count and the candidate's modeled traffic
    (the engine's per-dispatch-mode model for tiled; compulsory
    read + write for the dense methods)."""
    from repro_torch.core import engine
    from repro_torch.core.plan import as_torch_dtype
    from repro_torch.core.tilegraph import tile_grid
    from repro_torch.launch.roofline import modeled_seconds, qr_flops

    itemsize = as_torch_dtype(dtype).itemsize
    flops = qr_flops(m, n)
    if cfg.method == "tiled":
        nb = min(cfg.block, m, n)
        p, q = tile_grid(m, n, nb)
        dma = engine.modeled_dma_bytes(p, q, nb, itemsize)
        key = cfg.dispatch_mode if (cfg.use_kernel and cfg.dispatch_mode
                                    in dma) else "wavefront"
        hbm = dma[key]
    elif cfg.method in ("geqr2", "geqr2_ht"):
        # Unblocked: every reflector re-streams the trailing matrix.
        hbm = 2.0 * min(m, n) * m * n * itemsize / 2.0
    else:
        hbm = 2.0 * (m * n + m * min(m, n) + min(m, n) * n) * itemsize
    return 1e6 * modeled_seconds(flops, hbm, dtype=dtype_name(dtype))


def prune_candidates(cands: Sequence[Tuple[str, "object"]], m: int, n: int,
                     dtype) -> List[Tuple[str, "object"]]:
    """Drop candidates whose modeled lower bound already loses by
    :data:`PRUNE_FACTOR` x — logged and counted, never silently."""
    bounds = {label: modeled_bound_us(cfg, m, n, dtype)
              for label, cfg in cands}
    floor = min(bounds.values())
    kept = []
    for label, cfg in cands:
        if bounds[label] > PRUNE_FACTOR * floor:
            _metrics.counter("tuning.candidates", status="pruned").inc()
            print(f"  pruned {label}: modeled {bounds[label]:.0f} us > "
                  f"{PRUNE_FACTOR:g}x floor {floor:.0f} us", file=sys.stderr)
        else:
            kept.append((label, cfg))
    return kept


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_candidate(cfg, a: torch.Tensor, reps: int = 3, *,
                      backend: Optional[str] = None) -> Optional[float]:
    """Min wall time (us) of ``reps`` solves of ``a`` after two warm ones,
    the device synchronized around each; None when the plan is infeasible
    for this shape (a planning ``ValueError``).  A failure of the solve
    itself — a kernel's fault, a failed build — raises."""
    from repro_torch.core.plan import plan

    backend = a.device.type if backend is None else backend
    try:
        solver = plan(tuple(a.shape), a.dtype, cfg, backend=backend)
    except ValueError as e:
        _metrics.counter("tuning.candidates", status="skipped").inc()
        print(f"  skipped {cfg.method}: {e}", file=sys.stderr)
        return None
    solver.solve(a)  # first run: builds, uploads tables
    solver.solve(a)  # warm caches
    walls = []
    for _ in range(reps):
        _sync(a.device)
        t0 = time.perf_counter()
        solver.solve(a)
        _sync(a.device)
        walls.append(time.perf_counter() - t0)
    return float(min(walls) * 1e6)


def _device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def sweep_shapes(shapes: Sequence[Tuple[int, int]], *,
                 dtype=torch.float32, reps: int = 3, device=None,
                 smoke: bool = False) -> TuningCache:
    """Measure every candidate on every shape class on ``device`` (None
    means "cuda"; entries are keyed by its type as the backend); return
    the cache."""
    from repro_torch.core.plan import as_torch_dtype, resolve_device

    device = resolve_device(device)
    backend = device.type
    device_kind = _device_kind(device)
    tdtype = as_torch_dtype(dtype)
    dt = dtype_name(tdtype)
    rng = np.random.default_rng(0)
    out = TuningCache(source="sweep")

    with _trace.span("tuning.sweep", backend=backend, shapes=len(shapes)):
        for m, n in shapes:
            cls = shape_class(m, n)
            label_cls = f"{cls[0]}x{cls[1]}"
            print(f"sweep {m}x{n} (class {label_cls}, {backend}/{dt})",
                  file=sys.stderr)
            _metrics.counter("tuning.sweeps", backend=backend).inc()
            heur = _heuristic_config(cls[0], cls[1], tdtype, backend)
            with _trace.span("tuning.shape", cls=label_cls):
                cands = prune_candidates(
                    candidates(cls[0], cls[1], tdtype, backend),
                    cls[0], cls[1], tdtype)
                a = torch.from_numpy(rng.standard_normal(
                    cls, dtype=np.float32)).to(device=device, dtype=tdtype)
                timings: Dict[str, float] = {}
                for label, cfg in cands:
                    us = measure_candidate(cfg, a, reps, backend=backend)
                    if us is None:
                        continue
                    timings[label] = us
                    _metrics.counter("tuning.candidates",
                                     status="measured").inc()
                    _metrics.histogram("tuning.candidate_wall_us",
                                       cls=label_cls).observe(us)
                    print(f"  {label:<24s} {us:10.0f} us", file=sys.stderr)
            if not timings:
                print(f"  no measurable candidate for {label_cls} — "
                      "class skipped", file=sys.stderr)
                continue
            best_label = min(timings, key=timings.get)
            best_cfg = dict(cands)[best_label]
            heur_label = next((lb for lb, c in cands
                               if _cand_key(c, backend)
                               == _cand_key(heur, backend)), None)
            heur_us = timings.get(heur_label, float("nan"))
            entry = TuningEntry(
                backend=backend, device_kind=device_kind,
                shape_class=cls, dtype=dt,
                best=TunedConfig(
                    method=best_cfg.method, block=best_cfg.block,
                    dispatch_mode=best_cfg.dispatch_mode,
                    q_method=best_cfg.q_method,
                    use_kernel=_resolved_use_kernel(best_cfg, backend)),
                best_us=timings[best_label],
                heuristic_method=heur.method, heuristic_us=heur_us,
                timings=tuple(sorted(timings.items())),
                provenance=tuple(sorted({
                    "generated_by": "repro_torch.tuning.sweep",
                    "mode": "r", "reps": str(reps),
                    "smoke": str(bool(smoke)).lower(),
                }.items())),
            )
            out.add(entry)
            _metrics.counter("tuning.entries", backend=backend).inc()
            print(f"  best: {best_label} ({entry.best_us:.0f} us) vs "
                  f"heuristic {heur.method} ({heur_us:.0f} us)",
                  file=sys.stderr)
    return out


def check_cache(fresh: TuningCache, baseline: Optional[TuningCache] = None,
                *, heuristic_tol: float = 0.05,
                drift_tol: float = 5.0) -> List[str]:
    """The gate: problem strings, empty when it passes.

    Per fresh entry the tuned pick must not be slower than the measured
    heuristic pick (same-run comparison; ``heuristic_tol`` absorbs timer
    noise — the argmin construction makes big violations impossible, so
    this mostly guards hand-edited caches).  With a ``baseline`` (a saved
    cache), the fresh time of the baseline's best config must stay within
    ``drift_tol`` x of its recorded time."""
    problems = []
    for e in fresh.entries():
        if np.isfinite(e.heuristic_us) and \
                e.best_us > e.heuristic_us * (1.0 + heuristic_tol):
            problems.append(
                f"{e.backend}:{e.shape_class}: tuned {e.best.method} "
                f"{e.best_us:.0f} us slower than heuristic "
                f"{e.heuristic_method} {e.heuristic_us:.0f} us")
        if baseline is None:
            continue
        b = baseline.lookup(backend=e.backend, m=e.shape_class[0],
                            n=e.shape_class[1], dtype=e.dtype,
                            device_kind=e.device_kind)
        if b is None:
            continue
        base_best_label = _best_label(b)
        fresh_us = e.timings_dict.get(base_best_label)
        if fresh_us is not None and fresh_us > b.best_us * drift_tol:
            problems.append(
                f"{e.backend}:{e.shape_class}: saved best "
                f"{base_best_label} regressed {b.best_us:.0f} -> "
                f"{fresh_us:.0f} us (> {drift_tol:g}x band)")
    return problems


def _best_label(entry: TuningEntry) -> str:
    td = entry.timings_dict
    return min(td, key=td.get) if td else entry.best.method


def _parse_shapes(text: str) -> Tuple[Tuple[int, int], ...]:
    out = []
    for part in text.split(","):
        m, n = part.lower().split("x")
        out.append((int(m), int(n)))
    return tuple(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="measure candidate QR configs per shape class on the "
                    "device and write the planner tuning cache")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="where to write the cache JSON")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated MxN list (default: full grid)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid (%s)" % (SMOKE_SHAPES,))
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="fail (exit 1) when a tuned pick is slower than "
                         "the heuristic pick or the baseline regressed")
    ap.add_argument("--baseline", default=DEFAULT_CACHE_PATH, metavar="PATH",
                    help="saved cache the drift gate compares against")
    ap.add_argument("--heuristic-tol", type=float, default=0.05)
    ap.add_argument("--drift", type=float, default=5.0,
                    help="allowed factor vs the baseline's recorded times")
    args = ap.parse_args(argv)

    shapes = (_parse_shapes(args.shapes) if args.shapes
              else SMOKE_SHAPES if args.smoke else DEFAULT_SHAPES)
    cache = sweep_shapes(shapes, dtype=args.dtype, reps=args.reps,
                         device=args.device, smoke=args.smoke)
    if args.out:
        cache.save(args.out)
        print(f"wrote {len(cache)} entries to {args.out}", file=sys.stderr)
    if args.check:
        baseline = None
        try:
            baseline = TuningCache.load(args.baseline)
        except (FileNotFoundError, ValueError):
            print(f"no usable baseline at {args.baseline}; "
                  "heuristic gate only", file=sys.stderr)
        problems = check_cache(cache, baseline,
                               heuristic_tol=args.heuristic_tol,
                               drift_tol=args.drift)
        for p in problems:
            print(f"GATE: {p}", file=sys.stderr)
        if problems:
            return 1
        print("tuning gate passed: tuned picks beat (or tie) heuristics "
              f"on all {len(cache)} swept classes", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
