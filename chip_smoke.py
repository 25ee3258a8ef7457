#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

  1. print the card's name and power limit (``nvidia-smi``);
  2. build the four macro-op kernels from ``src/repro_torch/kernels/csrc``
     and print the build time and the compiler's resource report;
  3. hold each kernel against its plain PyTorch version on the card, at
     the batch sizes the 2048 x 2048 main path launches (plus fp64 cases
     and zero-padded tiles that take the exact ``tau = 0`` path), and time
     kernel, plain version and, where one PyTorch call computes the same
     function, that call;
  4. run the main path — ``repro_torch.qr(a)`` with the default config on a
     seeded 2048 x 2048 float32 matrix — check that it went through the
     kernels (launch counts equal to the schedule's), meets the
     conformance bar, and agrees with the plain lowering on the card, and
     time it beside ``torch.linalg.qr``;
  5. break the main path's time down: the factorization's host time, the
     device time of each kernel kind's launches, the device's busy share
     of one factorization (a ``torch.profiler`` trace), and the time of
     forming Q.

Each correctness check is shown to reject a control whose answer is only
TF32-grade: the kernels' written outputs rounded to TF32 (fp64: to fp32),
and the main path's plain lowering run with TF32 products.

The second-to-last line of output is a JSON object with one record per
kernel; the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits with status 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, no tensor cores): the kernels run FMA
# on the CUDA cores, so FP32 SIMT is their compute roof.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12

N = 2048          # main-path matrix size (the tiled route's single-device ceiling)
NB = 32           # default tile
P = Q = N // NB   # 64 x 64 tile grid

# FLOPs per task at tile nb (Householder QR 4/3 nb^3 and T 1/3 nb^3 for
# GEQRT; three triangular products for LARFB; the structured [R; A] QR
# 2 nb^3 and the stacked T 4/3 nb^3 for TSQRT; two full and one
# triangular product for SSRFB), and elements each task must move
# (inputs read once, outputs written once).
FLOPS = {"GEQRT": lambda nb: 5 * nb ** 3 / 3, "LARFB": lambda nb: 3 * nb ** 3,
         "TSQRT": lambda nb: 10 * nb ** 3 / 3, "SSRFB": lambda nb: 5 * nb ** 3}
ELEMS = {"GEQRT": lambda nb: 3 * nb * nb + nb, "LARFB": lambda nb: 4 * nb * nb,
         "TSQRT": lambda nb: 5 * nb * nb + nb, "SSRFB": lambda nb: 6 * nb * nb}

REPLACES = {
    "GEQRT": "src/repro/kernels/macro_ops.py:295",
    "LARFB": "src/repro/kernels/macro_ops.py:309",
    "TSQRT": "src/repro/kernels/macro_ops.py:322",
    "SSRFB": "src/repro/kernels/macro_ops.py:340",
}
SOURCE = "src/repro_torch/kernels/csrc/macro_ops.cu"


def log(*args):
    print(*args, flush=True)


def bound(kind, ntasks, nb, dtype_name):
    """Least time the card could take: max(FLOPs / peak, bytes / HBM rate)."""
    itemsize = 4 if dtype_name == "float32" else 8
    t_ops = ntasks * FLOPS[kind](nb) / PEAK_FLOPS[dtype_name]
    t_bytes = ntasks * ELEMS[kind](nb) * itemsize / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


# A spin kernel of this many cycles (~1 ms) holds the stream while the host
# enqueues the timed launches, so their events bracket device time only and
# not the host's launch latency.
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, reset=None, reps=20, warmup=3):
    """Median device time of ``fn`` over ``reps`` runs, each bracketed by
    CUDA events behind a spin kernel; ``reset`` (untimed) restores its
    inputs before each run."""
    times = []
    for n in range(warmup + reps):
        if reset is not None:
            reset()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        if n >= warmup:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_state(torch, engine, dtype, seed, device):
    """A random (64 x 64 grid, nb = 32) factor state, seeded from numpy."""
    rng = np.random.default_rng(seed)
    r = min(P, Q)
    shapes = [(P, Q, NB, NB), (r, NB, NB), (r, NB), (P, r, NB, NB), (P, r, NB)]
    return engine.FactorState(*(
        torch.from_numpy(rng.standard_normal(s)).to(device=device, dtype=dtype)
        for s in shapes))


def largest_batch(engine, kind):
    """(n, 3) int32 index array of the main path's largest ``kind`` batch."""
    best = max((lv[kind] for lv in engine.wavefront_task_arrays(P, Q)
                if kind in lv), key=len)
    return best


def round_low(torch, x):
    """``x`` rounded to TF32 (fp32 input: 10 mantissa bits kept, round to
    nearest) or to fp32 (fp64 input): a result only that accurate."""
    if x.dtype == torch.float64:
        return x.float().double()
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def max_err(torch, got, want):
    """max |got - want| over matching tensors, and max(1, max |want|);
    raises on a non-finite value on either side."""
    err, scale = 0.0, 1.0
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and torch.isfinite(w).all(), \
            "non-finite kernel or plain output"
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    return err, scale


def check_kernel(torch, engine, macro_ops, kind, idx_np, dtype, seed,
                 zero_pad=None, timing=False):
    """Run kernel and plain version on one seeded state; compare all five
    state tensors.  Tolerance: the two sum nb-term products in different
    orders, and the column loops carry each step's rounding into the
    next, so they differ by a few nb-term sums' rounding —
    max |kernel - plain| <= 4 * eps * nb * max(1, max |plain|).  The
    control (the kernel's written outputs rounded by :func:`round_low`)
    must fail it."""
    dev = torch.device("cuda")
    base = make_state(torch, engine, dtype, seed, dev)
    if zero_pad is not None:
        zero_pad(base)
    idx = torch.from_numpy(np.ascontiguousarray(idx_np)).to(dev)
    got = engine.FactorState(*(x.clone() for x in base))
    want = engine.FactorState(*(x.clone() for x in base))
    before = macro_ops.LAUNCHES[kind]
    macro_ops.run_batch(kind, got, idx, use_kernel=True)
    torch.cuda.synchronize()
    assert macro_ops.LAUNCHES[kind] == before + 1, f"{kind}: kernel not launched"
    macro_ops.run_batch(kind, want, idx, use_kernel=False)
    torch.cuda.synchronize()
    assert macro_ops.LAUNCHES[kind] == before + 1, f"{kind}: plain launched a kernel"
    err, scale = max_err(torch, got, want)
    eps = float(torch.finfo(dtype).eps)
    tol = 4 * eps * NB * scale
    control = [torch.where(g != b, round_low(torch, g), g)
               for g, b in zip(got, base)]
    control_err = max_err(torch, control, want)[0]
    res = dict(kind=kind, dtype=str(dtype).replace("torch.", ""),
               ntasks=int(idx_np.shape[0]), max_abs_err=err, tol=tol,
               control_err=control_err,
               ok=err <= tol and control_err > tol)
    if timing:
        work = engine.FactorState(*(x.clone() for x in base))

        def reset():
            for w_, b_ in zip(work, base):
                w_.copy_(b_)
        res["ms"] = time_ms(torch, lambda: macro_ops.run_batch(
            kind, work, idx, use_kernel=True), reset)
        res["plain_ms"] = time_ms(torch, lambda: macro_ops.run_batch(
            kind, work, idx, use_kernel=False), reset, reps=5, warmup=1)
        res["library_ms"] = library_ms(torch, kind, base, idx_np)
        res["bound_ms"], res["bound_by"] = bound(kind, idx_np.shape[0], NB,
                                                 res["dtype"])
    return res, got, want


def library_ms(torch, kind, st, idx_np):
    """One PyTorch call computing the same function on the batch's tiles,
    gathered outside the timed region: ``torch.geqrf`` on the diagonal
    tiles (GEQRT) and on the stacked pairs ``[triu(D); A]`` (TSQRT);
    ``torch.ormqr`` applying the packed reflectors' Q^T to the trailing
    tiles (LARFB: V1 from the diagonal tile; SSRFB: the stacked
    ``[0; V2]`` to ``[C_k; C_i]``).  ormqr forms its block reflector from
    the taus, where the kernels read the stored T."""
    kk, ii, jj = (torch.from_numpy(idx_np[:, c].astype(np.int64)).cuda()
                  for c in range(3))
    if kind == "GEQRT":
        tiles = st.tiles[kk, kk].contiguous()
        return time_ms(torch, lambda: torch.geqrf(tiles))
    if kind == "LARFB":
        diag = st.tiles[kk, kk].contiguous()
        taus = st.d_taus[kk].contiguous()
        c = st.tiles[kk, jj].contiguous()
        return time_ms(torch, lambda: torch.ormqr(diag, taus, c, left=True,
                                                  transpose=True))
    if kind == "TSQRT":
        pairs = torch.cat([torch.triu(st.tiles[kk, kk]), st.tiles[ii, kk]],
                          dim=1).contiguous()
        return time_ms(torch, lambda: torch.geqrf(pairs))
    v2 = st.tiles[ii, kk]
    packed = torch.cat([torch.zeros_like(v2), v2], dim=1).contiguous()
    taus = st.t_taus[ii, kk].contiguous()
    c = torch.cat([st.tiles[kk, jj], st.tiles[ii, jj]], dim=1).contiguous()
    return time_ms(torch, lambda: torch.ormqr(packed, taus, c, left=True,
                                              transpose=True))


def phase_kernels(torch, engine, macro_ops):
    results = []
    geqrt_all = np.array([[k, k, k] for k in range(P)], np.int32)

    def pad_diag(st):       # tile (5, 5): rows and columns >= 20 are zero
        st.tiles[5, 5, 20:, :] = 0
        st.tiles[5, 5, :, 20:] = 0

    tsqrt_idx = largest_batch(engine, "TSQRT")
    zk, zi = int(tsqrt_idx[0, 0]), int(tsqrt_idx[0, 1])

    def pad_sub(st):        # the first TSQRT task's sub tile is all zero
        st.tiles[zi, zk] = 0

    cases = [
        ("GEQRT", largest_batch(engine, "GEQRT"), None, True),
        ("GEQRT", geqrt_all, pad_diag, False),
        ("LARFB", largest_batch(engine, "LARFB"), None, True),
        ("TSQRT", tsqrt_idx, pad_sub, True),
        ("SSRFB", largest_batch(engine, "SSRFB"), None, True),
    ]
    rows = {}
    for seed, (kind, idx, pad, timing) in enumerate(cases):
        for dtype in (torch.float32, torch.float64):
            res, got, want = check_kernel(torch, engine, macro_ops, kind, idx,
                                          dtype, seed, pad,
                                          timing=timing and dtype == torch.float32)
            if pad is pad_diag:     # exact tau = 0 on the zero-padded columns
                res["tau0_exact"] = bool((got.d_taus[5, 20:] == 0).all()
                                         and (want.d_taus[5, 20:] == 0).all())
                res["ok"] = res["ok"] and res["tau0_exact"]
            if pad is pad_sub:
                res["tau0_exact"] = bool((got.t_taus[zi, zk] == 0).all()
                                         and (want.t_taus[zi, zk] == 0).all())
                res["ok"] = res["ok"] and res["tau0_exact"]
            log("kernel check:", json.dumps(res))
            results.append(res)
            if "ms" in res:
                rows[kind] = res
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel checks failed: {bad}")
    return rows, results


def phase_main_path(torch, engine, macro_ops, repro_torch):
    rng = np.random.default_rng(N)
    a = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32)).cuda()
    solver = repro_torch.plan(a.shape, a.dtype, backend="cuda", explain=True)
    cfg = solver.config
    log("plan:", json.dumps(dict(
        method=cfg.method, use_kernel=cfg.use_kernel, block=cfg.block,
        dispatch_mode=cfg.dispatch_mode,
        decisions=[[d.rule, d.outcome, d.reason]
                   for d in solver.explain.decisions])))
    assert (cfg.method, cfg.use_kernel, cfg.dispatch_mode) == (
        "tiled", True, "wavefront"), cfg

    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    q, r = repro_torch.qr(a)
    torch.cuda.synchronize()
    launches = dict(macro_ops.LAUNCHES)
    expected = engine.dispatch_counts(P, Q)
    log("main path launches:", json.dumps(launches), "expected:",
        json.dumps(expected))

    eps = float(torch.finfo(torch.float32).eps)
    bar = 100 * eps * N
    q64, r64, a64 = q.double(), r.double(), a.double()
    ortho = float((q64.T @ q64 - torch.eye(N, dtype=torch.float64,
                                            device="cuda")).abs().max())
    resid = float(torch.linalg.norm(a64 - q64 @ r64) / torch.linalg.norm(a64))

    q0, r0 = repro_torch.qr(a, config=repro_torch.QRConfig(use_kernel=False))
    torch.cuda.synchronize()
    plain_launches = dict(macro_ops.LAUNCHES)
    # The lowerings sum in different orders.  Rounding in Householder QR
    # typically grows like sqrt(N) * eps (a random walk over the N steps);
    # the tolerance allows 4x that.  The TF32 control — the plain
    # lowering with TF32 products — must fail it.
    agree_tol = 4 * N ** 0.5 * eps
    finite = all(bool(torch.isfinite(x).all()) for x in (q, r, q0, r0))
    dq = float((q - q0).abs().max())
    dr = float((r - r0).abs().max() / r0.abs().max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qc, rc = repro_torch.qr(a, config=repro_torch.QRConfig(use_kernel=False))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctrl_launches = dict(macro_ops.LAUNCHES)
    dq_ctrl = float((qc - q).abs().max())
    dr_ctrl = float((rc - r).abs().max() / r.abs().max())
    # The same difference with each Q column signed by its R diagonal, so
    # a pivot whose sign the TF32 rounding flipped does not count.
    flip = torch.sign(torch.diagonal(rc)) * torch.sign(torch.diagonal(r))
    dq_ctrl_signed = float((qc * flip - q).abs().max())
    checks = dict(ortho=ortho, resid=resid, bar=bar, dq=dq, dr_rel=dr,
                  agree_tol=agree_tol, tf32_control_dq=dq_ctrl,
                  tf32_control_dr_rel=dr_ctrl,
                  tf32_control_dq_sign_matched=dq_ctrl_signed, finite=finite,
                  shapes=[list(q.shape), list(r.shape)])
    log("main path checks:", json.dumps(checks))

    def run_qr():
        repro_torch.qr(a)
        torch.cuda.synchronize()

    def run_lib():
        torch.linalg.qr(a)
        torch.cuda.synchronize()

    e2e = host_ms(run_qr, reps=5)
    lib = host_ms(run_lib, reps=5)
    log("main path timing:", json.dumps(dict(qr_ms=e2e, torch_linalg_qr_ms=lib)))

    assert launches == expected, (launches, expected)
    assert plain_launches == launches, "the plain lowering launched kernels"
    assert ctrl_launches == launches, "the TF32 control launched kernels"
    assert checks["finite"] and q.shape == (N, N) and r.shape == (N, N)
    assert ortho <= bar and resid <= bar, checks
    assert dq <= agree_tol and dr <= agree_tol, checks
    assert max(dq_ctrl, dr_ctrl) > agree_tol, ("the TF32 control passed", checks)
    return launches, e2e, lib


def busy_share(torch, engine, fresh):
    """The device's busy share of one factorization, from one
    ``torch.profiler`` trace of a real (not spin-gated) run: the union of
    the macro-op kernels' device intervals over the run's host wall time
    (profiling on) and over the device span from the first kernel's start
    to the last one's end.  None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("geqrt_kernel", "larfb_kernel", "tsqrt_kernel", "ssrfb_kernel")
    for _ in range(2):      # the first session pays the tracer's start-up
        state = fresh()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run_levels(state, use_kernel=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and any(n in e.name for n in names))
    if not spans:
        return dict(busy_share_of_wall=None, note="no device events traced")
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy_us += cur_e - cur_s
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3
    return dict(traced_kernels=len(spans), busy_ms=busy_us / 1e3,
                wall_ms_profiled=wall_ms, device_span_ms=span_ms,
                busy_share_of_wall=busy_us / 1e3 / wall_ms,
                busy_share_of_span=busy_us / 1e3 / span_ms)


def phase_breakdown(torch, engine, macro_ops, tilegraph, a):
    """Where the main path's time goes: the factorization's host time; the
    device time of each kind's launches, from CUDA events around every
    launch of one factorization enqueued behind a spin kernel long enough
    for the host to enqueue all of it (so the events see device time, not
    host gaps); the device's busy share of a real run (:func:`busy_share`);
    and the host time of forming Q."""
    def fresh():
        return engine.init_state(tilegraph._split_tiles(a, P, Q, NB))

    def factor():
        engine.run_levels(fresh(), use_kernel=True)
        torch.cuda.synchronize()

    factor_ms = host_ms(factor, reps=5)
    per_kind = dict.fromkeys(("GEQRT", "LARFB", "TSQRT", "SSRFB"), 0.0)
    state = fresh()
    indices = engine.level_indices(P, Q, a.device)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES * 200)
    timed = []
    for by_kind in indices:
        for kind, idx in by_kind.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            macro_ops.run_batch(kind, state, idx, use_kernel=True)
            end.record()
            timed.append((kind, start, end))
    torch.cuda.synchronize()
    for kind, start, end in timed:
        per_kind[kind] += start.elapsed_time(end)
    span_ms = timed[0][1].elapsed_time(timed[-1][2])

    def form_q():
        tilegraph._form_q_tiled(state, ncols=N)
        torch.cuda.synchronize()

    form_q_ms = host_ms(form_q, reps=3)
    total = sum(per_kind.values())
    out = dict(factor_host_ms=factor_ms, kernel_device_ms=per_kind,
               kernel_device_total_ms=total, spun_device_span_ms=span_ms,
               profiled=busy_share(torch, engine, fresh),
               form_q_host_ms=form_q_ms)
    log("main path breakdown:", json.dumps(out))
    return out


def host_ms(fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    from repro_torch.core import engine, tilegraph
    from repro_torch.kernels import _build, macro_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])

    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    rows, _ = phase_kernels(torch, engine, macro_ops)
    launches, e2e, lib = phase_main_path(torch, engine, macro_ops, repro_torch)
    a = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (N, N)).astype(np.float32)).cuda()
    phase_breakdown(torch, engine, macro_ops, tilegraph, a)

    kernels = []
    for kind in ("GEQRT", "LARFB", "TSQRT", "SSRFB"):
        r = rows[kind]
        kernels.append(dict(
            name=f"{kind.lower()}_kernel", route="cuda", source=SOURCE,
            replaces=REPLACES[kind], launches=launches[kind],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], ntasks=r["ntasks"]))
    log("card:", card, "| main path qr_ms", e2e, "| torch.linalg.qr ms", lib)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
