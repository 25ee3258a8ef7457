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
  3b. hold Q formation's updates (QLARFB, QSSRFB) against their plain
     versions the same way, at the 2048 x 2048 path's largest Q batches;
  4. run the main path — ``repro_torch.qr(a)`` with the default config on a
     seeded 2048 x 2048 float32 matrix — check that it went through the
     kernels (launch counts equal to the schedule's: Q formed in at most
     two launches a Q level), meets the conformance bar, and agrees with
     the plain lowering on the card, and time it beside
     ``torch.linalg.qr``;
  5. break the main path's time down: the factorization's host time, the
     device time of each kernel kind's launches, the device's busy share
     of one factorization (a ``torch.profiler`` trace), and Q formation on
     the kernels at 2048^2 and 640^2 (launches, host and device time,
     agreement with the plain Q loop on the same state);
  6. hold the megakernel and its batched twin against their plain walks
     (and their Q-table launches against the plain Q loop, the wavefront
     Q walk and single runs)
     (fp32 and fp64, 8 x 8 and 5 x 3 grids at nb = 32, stacks of 3 and,
     on the 5 x 3 grid, 7 slices, whose CTA runs cross slice boundaries),
     the megakernel against the wavefront kernels on the same workspace
     (bitwise), and each batched slice against a single megakernel run of
     it (bitwise);
  7. the megakernel path: ``repro_torch.qr`` on a seeded 640 x 640 float32
     matrix (the largest square the auto rule gives the megakernel) runs
     one megakernel launch, meets the conformance bar, agrees with the
     plain lowering, and is timed beside ``torch.linalg.qr`` and the
     forced wavefront lowering;
  8. the batched path: ``repro_torch.qr`` on a seeded (60, 576, 576)
     float32 stack (the shape class of SmolLM-135M's 60 q/o projections)
     runs one batched megakernel launch and one over the Q table, every
     slice inside the bar, timed beside ``torch.linalg.qr`` on the stack
     and the slice-by-slice loop of the wavefront lowering, with Q
     formation's host and device time;
  9. time both megakernels at those shapes (and the batched one on a
     (15, 576, 576) stack) against their plain walks, their bound and
     ``torch.geqrf``, with each one's ms per level and resident CTAs per
     SM, and their launches over the Q table against the plain Q walk and
     ``torch.linalg.householder_product``; and each of the four task
     bodies alone, one task per launch (nb = 32, fp32), since the slowest
     body of a level sets its time;
 10. hold the panel path's kernels against their plain versions (fp32
     and fp64): ``mht_panel`` and ``wy_trailing`` at the shapes its main
     paths give them, and the single-tile ``tsqrt`` / ``ssrfb`` entry
     points; time each beside its bound, its plain version and one
     PyTorch call (``torch.geqrf``, ``torch.ormqr``), the panel kernel's
     path (cluster or group, CTAs per panel) and microseconds per column
     at each panel shape it times, and the trailing kernel's layout
     (cluster of G CTAs sized for one or two CTAs an SM, or streaming) at
     each;
 11. the panel path: ``repro_torch.qr`` through the auto route on a
     (60, 576, 192) stack, 4096^2, 49152 x 576 (TSQR), 200^2 and 16 x 1000
     (one wide panel): route, launch counts, conformance, agreement with
     the plain lowering, timed beside ``torch.linalg.qr``;
 12. break the panel path's time down (panel kernel, trailing kernel,
     other device work, Q formation, host) with ``torch.profiler``;
 13. the QR service (``repro_torch.serving.QRService``) on the card:
     (a) the serving benchmark's mix, 16-request waves of 64^2 to 130 x
     120 fp32 (one warm-up wave, 8 timed waves, one wave in mode "r", one
     in fp64): no plan built after the warm-up, each bucket on the engine
     auto rule's rung (the batched megakernel), one batched megakernel
     launch a bucket and one over its Q table, no escalation, every answer
     inside the bar of its own shape and within 4 sqrt(N) eps of the plain
     lowering on the same padded stack (the TF32 control failing); p50 /
     p99 wave latency, matrices/s, bucket fill and plan-cache hit rate,
     beside the same requests served one flush per request and
     ``torch.linalg.qr`` request by request; (b) one optimizer step's
     attention momenta of SmolLM-135M, 60 x (576, 576) and 60 x (576,
     192): a 768^2 bucket of batch 64 on the wavefront kernels and a 768 x
     192 one on the batched megakernel, the same checks, the padding waste
     of each bucket; (c) one fault of each site (compile, dispatch, output,
     vmem, input) with the reference's hops and counters, every recovered
     answer inside the bar, and the circuit breaker; (d) ``qr(verify=True)``
     at 2048^2 and on the (60, 576, 576) stack, no escalation, its cost
     beside the unverified ``qr``; (e) ``observability.capture`` around a
     service wave names the ``serving.*`` spans and the megakernel labels,
     and a disabled span costs under 1% of a 2048^2 ``qr``.
 14. QR-Muon training of SmolLM-135M at full width (30 layers, d_model
     576, vocab 49,152; ``SyntheticLM`` batch 8 x 512, seed 0;
     ``TrainConfig(optimizer="muon-qr", batched_ortho=True)``): (a) one
     step's 210 momenta through ``batched_orthogonalize`` on the kernels
     and through the plain lowering on the card — 3 shape classes, 3
     dispatches, no leafwise matrix, the literal launches of each class,
     every O in the conformance bar and a QR Q of its momentum to 4
     sqrt(N) eps in backward error, the kernels' O within 4 sqrt(N) eps
     x cond of the plain lowering's (the same within 4 sqrt(N) eps on
     Gaussian stacks of the same shapes), a TF32 control failing; (b)
     one warm-up and three timed steps: step ms, tokens/s, and from one
     instrumented step fwd+bwd, optimizer and per-class ms, beside the
     optimizer alone (batched and the leafwise default, no kernel),
     ``torch.linalg.qr`` over the same stacks and a ``torch.profiler``
     trace of fwd+bwd and of the 1536 x 576 class (device busy share);
     (c) the losses finite and within 1e-3 relative of a run from the
     same weights and batches whose orthogonalization runs the plain
     lowering; (d) the training run's launches of every kernel.
 15. the tuning layer: (a) ``dag.analyze_tiled``'s depth equals the levels
     phase 4's 2048^2 factorization dispatched (190) and the 640^2
     megakernel's table (58), with beta beside the measured ms per level
     and the paper's theta curve; (b) ``tuning.sweep_shapes`` over the
     card's eight shape classes (fp32, reps 3): every candidate's us, the
     best and the heuristic pick, ``check_cache`` clean, and each class's
     tuned plan in the conformance bar and within 4 sqrt(N) eps of its
     plain lowering (a TF32 control failing); (c) with the fresh cache
     installed, ``plan`` selects ``tuned`` on every class, the 640^2 and
     (60, 576, 576) plans keep the megakernel unless the 768^2 entry
     measured both lowerings (ROADMAP C7), and ``qr`` ms with and without
     the cache at each class edge, 200^2 and 640^2; (d) a warm service
     counts one plan invalidation and resets its open breaker when the
     cache is installed, and its 768^2 bucket's rung follows the entry;
     (e) the sweep's launches of every kernel; the active cache is
     restored afterwards.
 16. the distributed layer, on ranks spawned with ``torch.multiprocessing``
     (``spawn``: gloo process groups through a ``file://`` store under
     ``$TMPDIR``; every rank time-shares the one card, so the times are
     correctness and cost numbers, not scaling): (a) ``repro_torch.qr`` on
     a seeded 4096^2 fp32 matrix through the auto route at d = 2 and d = 4
     ranks (``sharded_tiled`` at block 64: per-domain wavefront sweeps and
     the butterfly merge on the panel kernels) — each rank's launches
     equal to the schedule's, the conformance bar and the tight gate 4
     sqrt(N) eps on ||Q^T Q - I|| and ||A - QR|| / ||A|| (which a
     TF32-rounded control fails), R against fp64 ``torch.linalg.qr`` up to
     column signs, the same bits of Q and R on every rank; ``qr`` ms per
     rank (median of 3), the merge's and the collectives' share of a
     traced call, beside ``torch.linalg.qr`` and the one-process ``qr``;
     (b) ``distributed_qr`` of a 49152 x 576 matrix over 4 ranks, the same
     checks; (c) ``compressed_psum`` of a 1e6-element vector a rank over
     2 ranks, against the mean of the decoded contributions (fp32
     rounding) and the true mean (1/127 of the block max); (d) SmolLM-135M
     (phase 14's configuration): a run stopped at step 3 of 4 with
     checkpoints every 2 under ``$TMPDIR``, a restored run to step 4 and
     an uninterrupted one — the restored state equal to the saved one bit
     for bit, the step-4 losses within 1e-3; the checkpoint's bytes, the
     snapshot ms a non-blocking save costs the step loop and the write
     seconds; (e) 3 steps with ``grad_compression``: finite losses within
     5e-2 of the uncompressed run's, the codec's ms a step.  A rank that
     fails fails the phase.  Phase 16(a) opts in to the sharded route
     (``QRConfig(ndomains=d)``: a rank's own ``qr`` never counts the
     group otherwise, ROADMAP C10) and prints the copies check's cost.
 17. mesh training (``Trainer(mesh=...)``, phase 14's model, weights and
     batches, ``TrainConfig(optimizer="muon-qr", qr_shard_leaves=True)``):
     (a) on a (1, 1) ``("data", "model")`` CUDA mesh in this process (a
     one-rank gloo group) and without a mesh, one warm-up and three timed
     steps each: the losses within 1e-3 relative and the Muon leaves'
     first update within 1e-4 of the mesh-free run's (a run with TF32
     products in the optimizer failing the latter), every O of the
     warm-up step (the mesh route, whole) through phase 14's gates, step
     ms and tokens/s beside the mesh-free run's, the step's launches
     (the 1536 x 576 class's 90 slices on the wavefront rung, one batched
     megakernel launch and one over its Q table per 576^2 stack); (b) two
     spawned gloo ranks sharing the card on a (2, 1) mesh (FSDP on
     "data"; DTensor's collectives staged through host memory: gloo
     crashes on CUDA tensors): every rank's losses equal and within 1e-3
     of (a)'s, each rank's step launching half of the wavefront launches
     (15 of each stacked leaf's 30 layers) and the same batched and panel
     launches, step ms a rank (time-shared: cost, not scaling) and the
     1536 x 576 class's ms; on each rank, from the warm-up step's inputs,
     its layer-shard of every O of the mesh route (15-slice stacks)
     through phase 14's gates against the plain lowering on the same
     slices, and the update of the mesh route (whole) within 1e-4 of the
     mesh-free update of the same inputs, the mesh route with TF32
     products failing it; the whole parameters after step 2 against
     (a)'s mesh-free run (reported: the ranks' gradients are sums over
     half batches); (c) 17(b)'s checkpoint of step 3 restored
     onto the (1, 1) mesh that ``plan_elastic_mesh(failed=[1])`` plans:
     every leaf's sha256 equal to the saved one, step 4's loss within
     1e-3 of the uninterrupted run's; (d) C10 on the two ranks: each
     rank's own matrix raises ``DivergentCopiesError`` on both, and the
     copies check's ms at 4096^2.
 18. LM serving (``repro_torch.models`` / ``serving.ServeEngine``; none
     of the QR kernels, checked by their launch counts): (a) ``python -m
     repro_torch.launch.serve --arch xlstm-1.3b --batch 4 --prompt-len 256
     --steps 32``, whole (48 layers, 1,943,646,544 parameters), through
     its ``main`` in this process, its JSON line printed; (b) on
     xlstm-1.3b and smollm-135m, whole, and jamba-v0.1-52b at its
     published widths cut to one period (8 of 32 layers, 13.3e9
     parameters: mamba, GQA attention and MoE), weights drawn on the card
     from a generator seeded with 0, ``ServeEngine`` with batch 4, prompt
     256 and 32 new tokens: two greedy ``generate`` calls equal, the same
     tokens stepped by hand, request 0's tokens unchanged when request
     2's prompt changes (xlstm, smollm; MoE capacity couples one prefill
     batch's requests, as in the reference); prefill ms, decode ms a token
     (median of the steps) beside the bytes bound, tokens/s, peak memory,
     parameters; (c) the same weights in fp32 (jamba with capacity 8.0):
     prefill of 48 tokens and 16 decode steps against ``forward_train``
     over the 64 tokens, each step within 4x the model's own fp32 noise
     (``forward_train`` of the same tokens at batch 1 against batch 3, at
     most 1e-3; the gate at least 1e-5) relative to the largest |logit|,
     and the run with every carried cache and state rounded to bf16
     failing that; one ``torch.profiler`` trace of a decode step (device
     ops, busy ms and share).

Each correctness check is shown to reject a control whose answer is only
TF32-grade: the kernels' written outputs rounded to TF32 (fp64: to fp32),
the update kernels' plain versions and the plain Q loop run on inputs
rounded to TF32 (one-pass TF32 products), and the main paths' plain
lowering run with TF32 products.
Every phase prints its seconds.

The second-to-last line of output is a JSON object with one record per
kernel (``service_launches``: its launches on phase 13's service paths;
``training_launches``: on phase 14's warm-up and timed steps;
``tuning_launches``: in phase 15's sweep; ``distributed_launches``: in
phase 16, per rank for each sharded cell and in the restart run;
``mesh_launches``: in phase 17, (a)'s timed step and each (b) rank's;
``lm_serving_launches``: in phase 18, zero);
the last is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits with status 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

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
# Q formation's updates are LARFB's and SSRFB's with T for T^T.
FLOPS.update(QLARFB=FLOPS["LARFB"], QSSRFB=FLOPS["SSRFB"])
ELEMS.update(QLARFB=ELEMS["LARFB"], QSSRFB=ELEMS["SSRFB"])

REPLACES = {
    "GEQRT": "src/repro/kernels/macro_ops.py:295",
    "LARFB": "src/repro/kernels/macro_ops.py:309",
    "TSQRT": "src/repro/kernels/macro_ops.py:322",
    "SSRFB": "src/repro/kernels/macro_ops.py:340",
    "MEGAKERNEL": "src/repro/core/engine.py:803",
    "MEGAKERNEL_BATCHED": "src/repro/core/engine.py:814",
    "MHT_PANEL": "src/repro/kernels/mht_panel.py:48",
    "WY_TRAILING": "src/repro/kernels/wy_trailing.py:36",
    "TSQRT_TILE": "src/repro/kernels/tile_ops.py:83",
    "SSRFB_TILE": "src/repro/kernels/tile_ops.py:126",
    # Q formation runs LARFB's and SSRFB's kernels with T for T^T; the
    # reference computes it in jnp (src/repro/core/tilegraph.py:265).
    "QLARFB": "src/repro/kernels/macro_ops.py:309",
    "QSSRFB": "src/repro/kernels/macro_ops.py:340",
    "MEGAKERNEL_Q": "src/repro/core/engine.py:803",
    "MEGAKERNEL_Q_BATCHED": "src/repro/core/engine.py:814",
}
Q_FORMATION = "src/repro/core/tilegraph.py:265"

N_MEGA = 640            # 20 x 20 grid: the largest square the auto rule
                        # gives the megakernel (24 x 24's table is over budget)
STACK = (60, 576, 576)  # SmolLM-135M: 30 layers x (q, o) projections, d 576
SOURCE = "src/repro_torch/kernels/csrc/macro_ops.cu"
SOURCES = {"MHT_PANEL": "src/repro_torch/kernels/csrc/mht_panel.cu",
           "WY_TRAILING": "src/repro_torch/kernels/csrc/wy_trailing.cu",
           "TSQRT_TILE": SOURCE, "SSRFB_TILE": SOURCE}

# The panel path's configurations (phase 10): (label, shape, route slug).
PANEL_PATHS = (
    ("stack", (60, 576, 192), "blocked_default"),   # SmolLM-135M k/v momenta
    ("4096", (4096, 4096), "blocked_default"),      # past the tiled ceiling
    ("tsqr", (49152, 576), "tsqr_tall_skinny"),     # 8 leaves of (6144, 576)
    ("200", (200, 200), "blocked_default"),         # under the tiled floor
    ("wide", (16, 1000), "single_panel"),           # one wide panel
)


# Levels of the tiled factorization each main-path phase dispatched on
# the wavefront kernels (counted by :func:`count_levels`), keyed by label.
DISPATCHED_LEVELS = {}


@contextlib.contextmanager
def count_levels():
    """The distinct factorization levels dispatched inside the block: the
    engine names each (level, kind) launch batch with
    ``profiler.kernel_label`` just before it launches (Q formation's
    levels, QLARFB / QSSRFB, are not counted)."""
    from repro_torch.observability import profiler

    seen = set()
    label = profiler.kernel_label

    def spy(kind, level=None):
        if kind in ("GEQRT", "LARFB", "TSQRT", "SSRFB"):
            seen.add(level)
        return label(kind, level)

    profiler.kernel_label = spy
    try:
        yield seen
    finally:
        profiler.kernel_label = label


def log(*args):
    print(*args, flush=True)


def batch_elems(kind, idx_np, nb):
    """Elements a batch must move, each distinct tile read once and each
    output written once.  An update batch's tasks that share their V tile
    and block reflector (LARFB, QLARFB: tile (k, k) and D_k, one pair per
    k; SSRFB, QSSRFB: tile (i, k) and T_ik, one per (k, i)) need that pair
    once; every C tile is read and written (a level's writes are disjoint).
    GEQRT and TSQRT tasks share no tile."""
    n = len(idx_np)
    if kind not in ("LARFB", "SSRFB", "QLARFB", "QSSRFB"):
        return n * ELEMS[kind](nb)
    pairs = len({(int(k), int(i)) for k, i, _ in idx_np})
    c_tiles = 1 if kind in ("LARFB", "QLARFB") else 2
    return (2 * pairs + 2 * c_tiles * n) * nb * nb


def bound(kind, idx_np, nb, dtype_name):
    """Least time the card could take for the batch ``idx_np``
    (:func:`bound_ms`), bytes from :func:`batch_elems`."""
    return bound_ms(len(idx_np) * FLOPS[kind](nb),
                    batch_elems(kind, idx_np, nb), dtype_name)


# A spin kernel of this many cycles (~1 ms) holds the stream while the host
# enqueues the timed launches, so their events bracket device time only and
# not the host's launch latency.
SPIN_CYCLES = 2_000_000


def time_ms(torch, fn, reset=None, reps=20, warmup=3, spin=SPIN_CYCLES):
    """Median device time of ``fn`` over ``reps`` runs, each bracketed by
    CUDA events behind a spin kernel of ``spin`` cycles (longer than the
    host takes to enqueue ``fn``); ``reset`` (untimed) restores its inputs
    before each run."""
    times = []
    for n in range(warmup + reps):
        if reset is not None:
            reset()
        torch.cuda._sleep(spin)
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
    if kind in ("LARFB", "SSRFB") and dtype == torch.float32:
        # The one-pass TF32 control: the plain version with TF32 products.
        res["tf32_plain_err"] = max_err(torch, tf32_plain(
            torch, lambda st: macro_ops.run_batch(kind, st, idx,
                                                  use_kernel=False),
            base, engine), want)[0]
        res["ok"] = res["ok"] and res["tf32_plain_err"] > tol
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
        res["bound_ms"], res["bound_by"] = bound(kind, idx_np, NB,
                                                 res["dtype"])
    return res, got, want


def tf32_plain(torch, run, base, engine):
    """``run`` (a plain version, in place) on a copy of ``base`` whose
    entries are rounded to TF32: the products of one-pass TF32 (exact
    products of TF32 operands, summed in fp32), a result only that
    accurate.  (``allow_tf32`` is a hint that cuBLAS does not take for
    every batched shape.)"""
    work = engine.FactorState(*(round_low(torch, x) for x in base))
    run(work)
    torch.cuda.synchronize()
    return work


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
    # The update walk in fp64 (DMMA products) on the same batches.
    for seed, kind in enumerate(("LARFB", "SSRFB")):
        base = make_state(torch, engine, torch.float64, 20 + seed,
                          torch.device("cuda"))
        work = engine.FactorState(*(x.clone() for x in base))
        idx = torch.from_numpy(np.ascontiguousarray(
            largest_batch(engine, kind))).cuda()

        def reset():
            for w_, b_ in zip(work, base):
                w_.copy_(b_)
        rows[kind]["fp64_ms"] = time_ms(torch, lambda: macro_ops.run_batch(
            kind, work, idx, use_kernel=True), reset)
        rows[kind]["fp64_bound_ms"] = bound(
            kind, largest_batch(engine, kind), NB, "float64")[0]
        log(f"{kind} fp64 ms:", rows[kind]["fp64_ms"])
    return rows, results


def q_largest_batch(engine, kind, p=P, q=Q, qe=Q):
    """(n, 3) int32 index array of Q formation's largest ``kind`` batch."""
    return max((lv[kind] for lv in engine.q_task_arrays(p, q, qe)
                if kind in lv), key=len)


def phase_q_kernels(torch, engine, macro_ops):
    """Q formation's updates (QLARFB, QSSRFB: the walk kernel's Q kinds)
    against their plain versions on the card, fp32 and fp64, at the
    2048 x 2048 path's largest Q batch of each kind, on a seeded factor
    state and Q workspace: the bound is the kernel checks'
    4 * eps * nb * max(1, max |plain|), which the TF32-rounded outputs
    and (fp32) the plain version with TF32 products must both miss; the
    factored state must come out untouched (the TF32 control of fp32: the
    plain version on TF32-rounded inputs).  fp32 times: kernel, plain
    version, and ``torch.ormqr`` applying the same reflectors' Q (not
    Q^T) to the same tiles."""
    rows, results = {}, []
    dev = torch.device("cuda")
    for seed, kind in enumerate(("QLARFB", "QSSRFB")):
        idx_np = q_largest_batch(engine, kind)
        idx = torch.from_numpy(np.ascontiguousarray(idx_np)).to(dev)
        for dtype in (torch.float32, torch.float64):
            st = make_state(torch, engine, dtype, 40 + seed, dev)
            keep = [x.clone() for x in st]
            rng = np.random.default_rng(50 + seed)
            e0 = torch.from_numpy(rng.standard_normal((P, Q, NB, NB))).to(
                dev, dtype)
            got, want = e0.clone(), e0.clone()
            before = macro_ops.LAUNCHES[kind]
            macro_ops.run_q_batch(kind, st, got, idx, use_kernel=True)
            torch.cuda.synchronize()
            assert macro_ops.LAUNCHES[kind] == before + 1, f"{kind} not launched"
            macro_ops.run_q_batch(kind, st, want, idx, use_kernel=False)
            torch.cuda.synchronize()
            assert macro_ops.LAUNCHES[kind] == before + 1
            res = dict(kind=kind, dtype=str(dtype).replace("torch.", ""),
                       ntasks=int(idx_np.shape[0]),
                       grid_ctas=macro_ops.WALK_GRID[kind],
                       state_untouched=all(torch.equal(x, y)
                                           for x, y in zip(st, keep)),
                       **compare(torch, (got,), (want,), (e0,), NB, dtype))
            if dtype == torch.float32:
                # One-pass TF32: the plain version on TF32-rounded inputs.
                ctrl = round_low(torch, e0)
                macro_ops.run_q_batch(kind, engine.FactorState(*(
                    round_low(torch, x) for x in st)), ctrl, idx,
                    use_kernel=False)
                torch.cuda.synchronize()
                res["tf32_plain_err"] = max_err(torch, (ctrl,), (want,))[0]
                res["ok"] = res["ok"] and res["tf32_plain_err"] > res["tol"]
                work = e0.clone()
                res["ms"] = time_ms(torch, lambda: macro_ops.run_q_batch(
                    kind, st, work, idx, use_kernel=True), lambda: work.copy_(e0))
                res["plain_ms"] = time_ms(torch, lambda: macro_ops.run_q_batch(
                    kind, st, work, idx, use_kernel=False),
                    lambda: work.copy_(e0), reps=5, warmup=1)
                res["library_ms"] = q_library_ms(torch, kind, st, e0, idx_np)
                res["bound_ms"], res["bound_by"] = bound(
                    kind, idx_np, NB, res["dtype"])
                rows[kind] = res
            res["ok"] = res["ok"] and res["state_untouched"]
            log("Q kernel check:", json.dumps(res))
            results.append(res)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"Q kernel checks failed: {bad}")
    return rows


def q_library_ms(torch, kind, st, e, idx_np):
    """``torch.ormqr`` applying the batch's reflectors' Q (transpose=False)
    to its E tiles, gathered outside the timed region: QLARFB's V1 from
    the diagonal tile, QSSRFB's stacked ``[0; V2]`` to ``[E_k; E_i]``."""
    kk, ii, jj = (torch.from_numpy(idx_np[:, c].astype(np.int64)).cuda()
                  for c in range(3))
    if kind == "QLARFB":
        diag = st.tiles[kk, kk].contiguous()
        taus = st.d_taus[kk].contiguous()
        c = e[kk, jj].contiguous()
        return time_ms(torch, lambda: torch.ormqr(diag, taus, c, left=True,
                                                  transpose=False))
    v2 = st.tiles[ii, kk]
    packed = torch.cat([torch.zeros_like(v2), v2], dim=1).contiguous()
    taus = st.t_taus[ii, kk].contiguous()
    c = torch.cat([e[kk, jj], e[ii, jj]], dim=1).contiguous()
    return time_ms(torch, lambda: torch.ormqr(packed, taus, c, left=True,
                                              transpose=False))


def launch_counts(macro_ops):
    """The launch counters that are not zero."""
    return {k: v for k, v in macro_ops.LAUNCHES.items() if v}


def phase_main_path(torch, engine, macro_ops, repro_torch, n, mode, label):
    """``repro_torch.qr`` with the default config on a seeded n x n float32
    matrix: the plan resolves ``mode``, the call launches exactly the
    schedule's kernels, meets the conformance bar, and agrees with the
    plain lowering (a TF32 control must not); timed beside
    ``torch.linalg.qr``."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)).cuda()
    solver = repro_torch.plan(a.shape, a.dtype, backend="cuda", explain=True)
    cfg = solver.config
    log(f"{label} plan:", json.dumps(dict(
        method=cfg.method, use_kernel=cfg.use_kernel, block=cfg.block,
        dispatch_mode=cfg.dispatch_mode,
        decisions=[[d.rule, d.outcome, d.reason]
                   for d in solver.explain.decisions])))
    assert (cfg.method, cfg.use_kernel, cfg.dispatch_mode) == (
        "tiled", True, mode), cfg
    decision = ("dispatch_mode_auto" if mode == "megakernel"
                else "megakernel_over_budget")
    assert solver.explain.decision(decision) is not None, solver.explain

    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    with count_levels() as levels:
        q, r = repro_torch.qr(a)
        torch.cuda.synchronize()
    launches = launch_counts(macro_ops)
    DISPATCHED_LEVELS[label] = len(levels)
    g = n // NB
    expected = dict(engine.dispatch_counts(g, g, mode),
                    **engine.q_dispatch_counts(g, g, g, mode))
    q_levels = len(engine.q_task_arrays(g, g, g))
    log(f"{label} launches:", json.dumps(launches), "expected:",
        json.dumps(expected), "Q levels:", q_levels,
        "grid:", json.dumps(macro_ops.MEGAKERNEL_GRID))
    # Q forms on the kernels: one megakernel launch, or at most two
    # launches (QLARFB, QSSRFB) a Q level.
    if mode == "megakernel":
        assert launches.get("MEGAKERNEL_Q") == 1, launches
    else:
        assert 0 < launches.get("QLARFB", 0) + launches.get("QSSRFB", 0) \
            <= 2 * q_levels, launches

    eps = float(torch.finfo(torch.float32).eps)
    bar = 100 * eps * n
    q64, r64, a64 = q.double(), r.double(), a.double()
    ortho = float((q64.T @ q64 - torch.eye(n, dtype=torch.float64,
                                            device="cuda")).abs().max())
    resid = float(torch.linalg.norm(a64 - q64 @ r64) / torch.linalg.norm(a64))

    q0, r0 = repro_torch.qr(a, config=repro_torch.QRConfig(use_kernel=False))
    torch.cuda.synchronize()
    plain_launches = launch_counts(macro_ops)
    # The lowerings sum in different orders.  Rounding in Householder QR
    # typically grows like sqrt(N) * eps (a random walk over the N steps);
    # the tolerance allows 4x that.  The TF32 control — the plain
    # lowering with TF32 products — must fail it.
    agree_tol = 4 * n ** 0.5 * eps
    finite = all(bool(torch.isfinite(x).all()) for x in (q, r, q0, r0))
    dq = float((q - q0).abs().max())
    dr = float((r - r0).abs().max() / r0.abs().max())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qc, rc = repro_torch.qr(a, config=repro_torch.QRConfig(use_kernel=False))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctrl_launches = launch_counts(macro_ops)
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
    log(f"{label} checks:", json.dumps(checks))

    def run_qr():
        repro_torch.qr(a)
        torch.cuda.synchronize()

    def run_lib():
        torch.linalg.qr(a)
        torch.cuda.synchronize()

    e2e = host_ms(run_qr, reps=5)
    lib = host_ms(run_lib, reps=5)
    timing = dict(qr_ms=e2e, torch_linalg_qr_ms=lib)
    if mode == "megakernel":
        wave = repro_torch.QRConfig(dispatch_mode="wavefront")
        macro_ops.reset_launch_counts()
        repro_torch.qr(a, config=wave)
        torch.cuda.synchronize()
        wave_launches = launch_counts(macro_ops)
        wave_expected = dict(engine.dispatch_counts(g, g),
                             **engine.q_dispatch_counts(g, g, g))
        assert wave_launches == wave_expected, (wave_launches, wave_expected)

        def run_wave():
            repro_torch.qr(a, config=wave)
            torch.cuda.synchronize()
        timing.update(wavefront_qr_ms=host_ms(run_wave, reps=5),
                      wavefront_launches=sum(wave_launches.values()))
    log(f"{label} timing:", json.dumps(timing))

    assert launches == expected, (launches, expected)
    assert plain_launches == launches, "the plain lowering launched kernels"
    assert ctrl_launches == launches, "the TF32 control launched kernels"
    assert checks["finite"] and q.shape == (n, n) and r.shape == (n, n)
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

    names = ("geqrt_kernel", "tsqrt_kernel", "walk_kernel")
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

    total = sum(per_kind.values())
    out = dict(factor_host_ms=factor_ms, kernel_device_ms=per_kind,
               kernel_device_total_ms=total, spun_device_span_ms=span_ms,
               profiled=busy_share(torch, engine, fresh))
    log("main path breakdown:", json.dumps(out))
    # Q formation as qr runs it, at 2048^2 (wavefront) and at 640^2 (the
    # megakernel), each from its own factored state.
    out["form_q"] = q_formation(torch, engine, macro_ops, tilegraph, state,
                                N, "2048")
    a640 = torch.from_numpy(np.random.default_rng(N_MEGA).standard_normal(
        (N_MEGA, N_MEGA)).astype(np.float32)).cuda()
    g = N_MEGA // NB
    f640 = engine.factor_tiles(tilegraph._split_tiles(a640, g, g, NB), p=g,
                               q=g, nb=NB, use_kernel=True)
    out["form_q_640"] = q_formation(torch, engine, macro_ops, tilegraph, f640,
                                    N_MEGA, "640")
    return out


def q_formation(torch, engine, macro_ops, tilegraph, state, ncols, label):
    """Q formation on the kernels from a factored state, as ``qr`` runs it
    (``engine.form_q_tiles`` by the auto rule's lowering, then the join):
    its launches (one megakernel launch, or at most two a Q level), its
    host time (median of 5) and device time (CUDA events behind a spin
    kernel long enough for the host to enqueue every launch), held
    against the plain Q loop (``tilegraph._form_q_tiled``) on the same
    state within 4 * sqrt(N) * eps, N the rows, which the plain loop on
    the state rounded to TF32 must miss; the plain loop's host time beside
    it."""
    *lead, p, q, nb, _ = state.tiles.shape
    qe = ncols // nb
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    got = tilegraph._join_tiles(engine.form_q_tiles(state, ncols))
    torch.cuda.synchronize()
    launches = launch_counts(macro_ops)
    q_levels = len(engine.q_task_arrays(p, q, qe))
    want = tilegraph._form_q_tiled(state, ncols)
    # One-pass TF32: the plain Q loop on the factored state rounded to TF32.
    ctrl = tilegraph._form_q_tiled(engine.FactorState(*(
        round_low(torch, x) for x in state)), ncols)
    torch.cuda.synchronize()
    eps = float(torch.finfo(state.tiles.dtype).eps)
    tol = 4 * (p * nb) ** 0.5 * eps
    err = float((got - want).abs().max())
    ctrl_err = float((ctrl - want).abs().max())

    def run():
        tilegraph._join_tiles(engine.form_q_tiles(state, ncols))
        torch.cuda.synchronize()

    def run_plain():
        tilegraph._form_q_tiled(state, ncols)
        torch.cuda.synchronize()
    nlaunch = sum(launches.values())
    out = dict(shape=list(lead) + [p * nb, ncols], launches=launches,
               q_levels=q_levels, max_abs_err=err, tol=tol,
               tf32_plain_err=ctrl_err, host_ms=host_ms(run, reps=5),
               device_ms=time_ms(torch, lambda: engine.form_q_tiles(
                   state, ncols), reps=10,
                   spin=SPIN_CYCLES * (1 + nlaunch // 16)),
               plain_host_ms=host_ms(run_plain, reps=1))
    log(f"Q formation {label}:", json.dumps(out))
    if "MEGAKERNEL_Q" in launches or "MEGAKERNEL_Q_BATCHED" in launches:
        assert nlaunch == 1, launches
    else:
        assert set(launches) <= {"QLARFB", "QSSRFB"}, launches
        assert 0 < nlaunch <= 2 * q_levels, (launches, q_levels)
    assert err <= tol < ctrl_err, out
    return out


def stack_tiles(torch, shape, dtype, seed, ragged=False):
    """Seeded tiles of the given (..., p, q, nb, nb) shape on the card.
    ``ragged``: odd slices of a stack hold a matrix nb/2 rows and columns
    short of the grid, zero-padded, as a shape bucket stages them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)
    if ragged:
        h = shape[-1] // 2
        x[1::2, -1, :, h:, :] = 0
        x[1::2, :, -1, :, h:] = 0
    return x


def phase_megakernel_checks(torch, engine, macro_ops, tilegraph):
    """Both megakernels against their plain walks (the table's rows in
    order, one task at a time) on every state array, under the kernel
    checks' 4 * eps * nb * max(1, max |plain|) with a TF32-rounded
    control that must fail it; the megakernel against the wavefront
    kernels on the same workspace, and each batched slice against a
    single megakernel run of it: both bitwise, since every lowering runs
    the same compute functions on the same operands.  Then Q from each
    factored state: the Q megakernel (one launch, the batched one for a
    stack) within 4 * sqrt(N) * eps of the plain Q loop, bitwise equal to
    the wavefront Q walk, and each batched slice's Q to the single
    megakernel's.  A 7-slice stack of the (5, 3) grid gives CTA runs that
    cross slice boundaries."""
    results = []
    for seed, (p, q) in enumerate(((8, 8), (5, 3))):
        table = engine.megakernel_table(p, q, torch.device("cuda"))
        for dtype in (torch.float32, torch.float64):
            tol = 4 * float(torch.finfo(dtype).eps) * NB
            res = dict(grid=[p, q], dtype=str(dtype).replace("torch.", ""))
            # 7 slices of the (5, 3) grid: runs that cross slice boundaries.
            cases = (("MEGAKERNEL", None), ("MEGAKERNEL_BATCHED", 3)) + (
                (("MEGAKERNEL_BATCHED", 7),) if (p, q) == (5, 3) else ())
            for name, batch in cases:
                lead = () if batch is None else (batch,)
                base = stack_tiles(torch, lead + (p, q, NB, NB), dtype,
                                   100 + seed, ragged=batch is not None)
                kernel, plain = (
                    (macro_ops.megakernel, macro_ops.megakernel_plain)
                    if batch is None else
                    (macro_ops.megakernel_batched,
                     macro_ops.megakernel_batched_plain))
                got = engine.init_state(base.clone())
                before = macro_ops.LAUNCHES[name]
                kernel(got, *table)
                torch.cuda.synchronize()
                assert macro_ops.LAUNCHES[name] == before + 1, name
                want = engine.init_state(base.clone())
                plain(want, *table)
                torch.cuda.synchronize()
                assert macro_ops.LAUNCHES[name] == before + 1, \
                    f"{name}: plain launched a kernel"
                err, scale = max_err(torch, got, want)
                init = engine.init_state(base)
                control = [torch.where(g != b, round_low(torch, g), g)
                           for g, b in zip(got, init)]
                control_err = max_err(torch, control, want)[0]
                key = name.lower() + ("" if batch in (None, 3) else
                                      f"_{batch}")
                res[key] = dict(max_abs_err=err, tol=tol * scale,
                                control_err=control_err,
                                grid_ctas=macro_ops.MEGAKERNEL_GRID[name])
                ok = err <= tol * scale < control_err
                # Q formation from the factored state: the Q megakernel
                # (batched for a stack) in one launch.
                qname = "MEGAKERNEL_Q" + ("" if batch is None else "_BATCHED")
                qbefore = macro_ops.LAUNCHES[qname]
                q_mega = engine.form_q_tiles(got, p * NB,
                                             dispatch_mode="megakernel")
                torch.cuda.synchronize()
                ok = ok and macro_ops.LAUNCHES[qname] == qbefore + 1
                q_plain = tilegraph._form_q_tiled(got, p * NB)
                q_tol = 4 * (p * NB) ** 0.5 * float(torch.finfo(dtype).eps)
                res[key]["q_vs_plain_max_abs"] = float(
                    (tilegraph._join_tiles(q_mega) - q_plain).abs().max())
                ok = ok and res[key]["q_vs_plain_max_abs"] <= q_tol
                if batch is None:
                    wave = engine.init_state(base.clone())
                    engine.run_levels(wave, use_kernel=True)
                    torch.cuda.synchronize()
                    diff = [float((g - w).abs().max()) for g, w in zip(got, wave)]
                    res[key]["vs_wavefront_max_abs"] = diff
                    ok = ok and all(torch.equal(g, w) for g, w in zip(got, wave))
                    q_wave = engine.form_q_tiles(got, p * NB,
                                                 dispatch_mode="wavefront")
                    res[key]["q_vs_wavefront_max_abs"] = float(
                        (q_mega - q_wave).abs().max())
                    ok = ok and torch.equal(q_mega, q_wave)
                else:
                    diff, qdiff = [], []
                    for b in range(batch):
                        single = engine.init_state(base[b].clone())
                        macro_ops.megakernel(single, *table)
                        q_single = engine.form_q_tiles(
                            single, p * NB, dispatch_mode="megakernel")
                        torch.cuda.synchronize()
                        diff.append(max(float((g[b] - x).abs().max())
                                        for g, x in zip(got, single)))
                        qdiff.append(float((q_mega[b] - q_single).abs().max()))
                        ok = ok and all(torch.equal(g[b], x)
                                        for g, x in zip(got, single))
                        ok = ok and torch.equal(q_mega[b], q_single)
                    res[key]["slice_vs_single_max_abs"] = diff
                    res[key]["q_slice_vs_single_max_abs"] = qdiff
                res[key]["ok"] = bool(ok)
            res["ok"] = all(v["ok"] for v in res.values()
                            if isinstance(v, dict))
            log("megakernel check:", json.dumps(res))
            results.append(res)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"megakernel checks failed: {bad}")
    return results


def phase_batched_path(torch, engine, macro_ops, repro_torch, tilegraph):
    """``repro_torch.qr`` on a seeded (60, 576, 576) float32 stack: one
    batched megakernel launch, every slice inside the conformance bar and
    its R equal to a single call's; timed beside ``torch.linalg.qr`` on
    the stack and the slice-by-slice loops of the single path (wavefront,
    as the port ran stacks before, and megakernel)."""
    b, m, n = STACK
    rng = np.random.default_rng(m)
    stack = torch.from_numpy(rng.standard_normal(STACK).astype(np.float32)).cuda()
    solver = repro_torch.plan(stack.shape, stack.dtype, backend="cuda",
                              explain=True)
    cfg = solver.config
    log("batched path plan:", json.dumps(dict(
        method=cfg.method, use_kernel=cfg.use_kernel, block=cfg.block,
        dispatch_mode=cfg.dispatch_mode,
        decisions=[[d.rule, d.outcome] for d in solver.explain.decisions])))
    assert (cfg.method, cfg.use_kernel, cfg.dispatch_mode) == (
        "tiled", True, "megakernel"), cfg

    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    q, r = repro_torch.qr(stack)
    torch.cuda.synchronize()
    launches = launch_counts(macro_ops)
    expected = dict(engine.dispatch_counts(m // NB, n // NB, "megakernel", b),
                    **engine.q_dispatch_counts(m // NB, n // NB, n // NB,
                                               "megakernel", b))
    log("batched path launches:", json.dumps(launches), "expected:",
        json.dumps(expected), "grid:", json.dumps(macro_ops.MEGAKERNEL_GRID))

    eps = float(torch.finfo(torch.float32).eps)
    bar = 100 * eps * max(m, n)
    q64, r64, a64 = q.double(), r.double(), stack.double()
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    ortho = (q64.mT @ q64 - eye).abs().amax(dim=(-2, -1))
    resid = (torch.linalg.matrix_norm(a64 - q64 @ r64)
             / torch.linalg.matrix_norm(a64))
    q1, r1 = repro_torch.qr(stack[0])
    torch.cuda.synchronize()
    checks = dict(
        ortho_max=float(ortho.max()), resid_max=float(resid.max()), bar=bar,
        slices_in_bar=int(((ortho <= bar) & (resid <= bar)).sum()),
        finite=bool(torch.isfinite(q).all() and torch.isfinite(r).all()),
        slice0_r_equal_single=bool(torch.equal(r[0], r1)),
        slice0_q_vs_single_max_abs=float((q[0] - q1).abs().max()),
        shapes=[list(q.shape), list(r.shape)])
    log("batched path checks:", json.dumps(checks))

    def run_qr():
        repro_torch.qr(stack)
        torch.cuda.synchronize()

    def run_lib():
        torch.linalg.qr(stack)
        torch.cuda.synchronize()

    wave = repro_torch.QRConfig(dispatch_mode="wavefront")

    def run_loop(cfg_):
        def run():
            for x in stack:
                repro_torch.qr(x, config=cfg_)
            torch.cuda.synchronize()
        return run

    timing = dict(qr_ms=host_ms(run_qr, reps=3),
                  torch_linalg_qr_ms=host_ms(run_lib, reps=3),
                  per_slice_wavefront_ms=host_ms(run_loop(wave), reps=2),
                  per_slice_megakernel_ms=host_ms(run_loop(None), reps=2))
    log("batched path timing:", json.dumps(timing))
    g = m // NB
    f = engine.factor_tiles_batched(tilegraph._split_tiles(stack, g, g, NB),
                                    p=g, q=g, nb=NB, use_kernel=True)
    timing["form_q"] = q_formation(torch, engine, macro_ops, tilegraph, f, n,
                                   "stack")

    assert launches == expected, (launches, expected)
    assert checks["finite"] and checks["slices_in_bar"] == b, checks
    assert checks["slice0_r_equal_single"], checks
    return launches, timing


def megakernel_bound(engine, p, q, nb, batch, dtype_name):
    """Least time of a whole factorization of ``batch`` (p, q) grids:
    max(FLOPs / peak, bytes / HBM rate), FLOPs summed per kind over the
    table's tasks, bytes the workspace read once plus the workspace and
    the four reflector arrays written once.  Also the byte bounds of the
    per-task traffic (each task's tiles in and out) and of the
    reference's modeled megakernel traffic."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    itemsize = 4 if dtype_name == "float32" else 8
    table = engine.megakernel_task_table(p, q)[0]
    kinds = ("GEQRT", "LARFB", "TSQRT", "SSRFB")
    count = {k: int((table[:, 0] == n).sum()) * batch for n, k in enumerate(kinds)}
    flops = sum(count[k] * FLOPS[k](nb) for k in kinds)
    r = min(p, q)
    elems = batch * (2 * p * q * nb * nb + r * nb * nb + r * nb
                     + p * r * nb * nb + p * r * nb)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = elems * itemsize / HBM_BW
    task_bytes = sum(count[k] * ELEMS[k](nb) for k in kinds) * itemsize
    modeled = engine.modeled_dma_bytes(p, q, nb, itemsize)["megakernel"] * batch
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops > t_bytes else "bytes",
                flops=flops, bytes=elems * itemsize,
                task_traffic_bound_ms=task_bytes / HBM_BW * 1e3,
                modeled_dma_bound_ms=modeled / HBM_BW * 1e3)


def phase_task_bodies(torch, engine, macro_ops):
    """Each task body alone: the wavefront kernel of its kind on one task
    (nb = 32, fp32), timed as :func:`time_ms` does (CUDA events behind a
    spin kernel, the state restored untimed).  In the megakernel a level
    lasts as long as its slowest task, so these set the level time."""
    base = make_state(torch, engine, torch.float32, 7, torch.device("cuda"))
    work = engine.FactorState(*(x.clone() for x in base))

    def reset():
        for w_, b_ in zip(work, base):
            w_.copy_(b_)
    out = {}
    for kind, task in (("GEQRT", [0, 0, 0]), ("LARFB", [0, 0, 1]),
                       ("TSQRT", [0, 1, 0]), ("SSRFB", [0, 1, 1])):
        idx = torch.tensor([task], dtype=torch.int32, device="cuda")
        out[kind] = time_ms(torch, lambda: macro_ops.run_batch(
            kind, work, idx, use_kernel=True), reset) * 1e3
    log("task bodies, one task per launch (nb = 32, fp32), us:",
        json.dumps(out))
    return out


def phase_megakernel_timing(torch, engine, macro_ops, tilegraph):
    """Both megakernels at the shapes their main paths give them (a
    640 x 640 matrix; the (60, 576, 576) stack; and a (15, 576, 576)
    stack), fp32: held against their plain walks on the same inputs, then
    timed — kernel, plain walk (not for the 15-slice stack) and
    ``torch.geqrf`` on the same matrix or stack — each run bracketed by
    CUDA events behind a spin kernel, the workspace restored untimed,
    with the resident CTAs per SM the occupancy query gives the launch
    and the ms per level.

    Tolerance of the whole factorization: the kernel check's
    4 * eps * nb * max(1, max |plain|) per step, grown over the min(p, q)
    panel steps as a random walk, times sqrt(min(p, q)) — every step's
    trailing update adds its own summation-order rounding to the tiles
    below and right of it.  The TF32-rounded control must fail it.  Every
    slice of the batched run must equal a single megakernel run of it."""
    rows = {}
    # A quarter of the stack too: the batched walk at another stack size.
    cases = (("MEGAKERNEL", (N_MEGA, N_MEGA), None),
             ("MEGAKERNEL_BATCHED", STACK[1:], STACK[0]),
             ("MEGAKERNEL_BATCHED", STACK[1:], STACK[0] // 4))
    for seed, (name, (m, n), batch) in enumerate(cases):
        label = name if batch in (None, STACK[0]) else f"{name}_{batch}"
        p, q = m // NB, n // NB
        lead = () if batch is None else (batch,)
        rng = np.random.default_rng(200 + seed)
        a = torch.from_numpy(rng.standard_normal(lead + (m, n)).astype(
            np.float32)).cuda()
        base = tilegraph._split_tiles(a, p, q, NB)
        table = engine.megakernel_table(p, q, a.device)
        kernel, plain = ((macro_ops.megakernel, macro_ops.megakernel_plain)
                         if batch is None else
                         (macro_ops.megakernel_batched,
                          macro_ops.megakernel_batched_plain))
        got = engine.init_state(base.clone())
        kernel(got, *table)
        want = engine.init_state(base.clone())
        plain(want, *table)
        torch.cuda.synchronize()
        err, scale = max_err(torch, got, want)
        tol = (4 * float(torch.finfo(torch.float32).eps) * NB * scale
               * min(p, q) ** 0.5)
        init = engine.init_state(base)
        control_err = max_err(torch, [
            torch.where(g != b, round_low(torch, g), g)
            for g, b in zip(got, init)], want)[0]
        by_field = {f: float((g - w).abs().max())
                    for f, g, w in zip(engine.FactorState._fields, got, want)}
        slices_equal = None
        if batch is not None:
            slices_equal = 0
            for b in range(batch):
                single = engine.init_state(base[b].clone())
                macro_ops.megakernel(single, *table)
                slices_equal += all(torch.equal(g[b], x)
                                    for g, x in zip(got, single))
        work = engine.init_state(base.clone())

        def reset():
            work.tiles.copy_(base)
        res = dict(kernel=name, shape=list(lead + (m, n)), grid=[p, q],
                   levels=table[1],
                   max_abs_err=err, tol=tol, control_err=control_err,
                   err_by_field=by_field, slices_equal_single=slices_equal,
                   grid_ctas=macro_ops.MEGAKERNEL_GRID[name],
                   ctas_per_sm=macro_ops.MEGAKERNEL_OCCUPANCY[name]["per_sm"],
                   stages=macro_ops.megakernel_stages(NB, 4),
                   smem_bytes=macro_ops.megakernel_launch_smem_bytes(NB, 4),
                   ms=time_ms(torch, lambda: kernel(work, *table), reset),
                   plain_ms=(time_ms(torch, lambda: plain(work, *table),
                                     reset, reps=2, warmup=1)
                             if label == name else None),
                   library_ms=time_ms(torch, lambda: torch.geqrf(a), reps=5),
                   **megakernel_bound(engine, p, q, NB, batch or 1, "float32"))
        if batch is None:
            # The same factorization by the wavefront kernels (147 launches,
            # enqueued behind a spin long enough to cover the host), and
            # both lowerings' factorization on the host clock.
            res["wavefront_ms"] = time_ms(
                torch, lambda: engine.run_levels(work, use_kernel=True),
                reset, reps=10, spin=SPIN_CYCLES * 20)

            def factor(mode):
                def run():
                    engine.factor_tiles(base.clone(), p=p, q=q, nb=NB,
                                        use_kernel=True, dispatch_mode=mode)
                    torch.cuda.synchronize()
                return run
            res["factor_host_ms"] = host_ms(factor("megakernel"), reps=5)
            res["wavefront_factor_host_ms"] = host_ms(factor("wavefront"),
                                                      reps=5)
        res["ms_per_level"] = res["ms"] / table[1]
        log("megakernel timing:", json.dumps(res))
        log(f"{label}: {res['ctas_per_sm']} resident CTAs per SM "
            f"({res['grid_ctas']} CTAs, {res['smem_bytes']} B of shared "
            f"memory, {res['stages']} operand buffers per slot), "
            f"{res['ms_per_level'] * 1e3:.2f} us per level")
        if not err <= tol < control_err or slices_equal not in (None, batch):
            raise SystemExit(f"{label} check failed: {res}")
        rows[label] = res
        qlabel = label.replace("MEGAKERNEL", "MEGAKERNEL_Q")
        rows[qlabel] = q_megakernel_timing(torch, engine, macro_ops, got, a,
                                           batch, label == name)
    return rows


def q_megakernel_timing(torch, engine, macro_ops, state, a, batch, plain):
    """The Q megakernel (batched for a stack) over the Q table from a
    factored state: held against its plain walk within 4 * sqrt(N) * eps
    (N the rows), then timed — kernel, plain walk (``plain``) and
    ``torch.linalg.householder_product`` forming Q from ``torch.geqrf`` of
    the same matrix or stack — beside its bound (the factored state read
    once, E written once; the Q updates' FLOPs)."""
    *lead, p, q, nb, _ = state.tiles.shape
    qe = q
    name = "MEGAKERNEL_Q" + ("" if batch is None else "_BATCHED")
    kernel, walk = ((macro_ops.megakernel_q, macro_ops.megakernel_q_plain)
                    if batch is None else
                    (macro_ops.megakernel_q_batched,
                     macro_ops.megakernel_q_batched_plain))
    table = engine.q_megakernel_table(p, q, qe, a.device)
    e0 = engine.q_workspace(tuple(lead), p, qe, nb, a.dtype, a.device)
    got, want = e0.clone(), e0.clone()
    kernel(state, got, *table)
    walk(state, want, *table)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 4 * (p * nb) ** 0.5 * float(torch.finfo(a.dtype).eps)
    work = e0.clone()
    h, tau = torch.geqrf(a)
    kinds = table[0][:, 0]
    nl = int((kinds == macro_ops.Q_KIND_ID["QLARFB"]).sum()) * (batch or 1)
    ns = int((kinds == macro_ops.Q_KIND_ID["QSSRFB"]).sum()) * (batch or 1)
    flops = nl * FLOPS["QLARFB"](nb) + ns * FLOPS["QSSRFB"](nb)
    r = min(p, q)
    elems = (batch or 1) * (p * q + r + p * r + p * qe) * nb * nb
    res = dict(kernel=name, shape=list(a.shape), levels=table[1], tasks=nl + ns,
               max_abs_err=err, tol=tol,
               grid_ctas=macro_ops.MEGAKERNEL_GRID[name],
               ms=time_ms(torch, lambda: kernel(state, work, *table),
                          lambda: work.copy_(e0)),
               plain_ms=(time_ms(torch, lambda: walk(state, work, *table),
                                 lambda: work.copy_(e0), reps=2, warmup=1)
                         if plain else None),
               library_ms=time_ms(torch, lambda: torch.linalg.householder_product(
                   h, tau), reps=5),
               **dict(zip(("bound_ms", "bound_by"),
                          bound_ms(flops, elems, "float32"))))
    res["ms_per_level"] = res["ms"] / table[1]
    log("Q megakernel timing:", json.dumps(res))
    if not err <= tol:
        raise SystemExit(f"{name} check failed: {res}")
    return res


# ---------------------------------------------------------------------------
# the panel path: mht_panel, wy_trailing and the single-tile entry points
# ---------------------------------------------------------------------------

def panel_flops(m, b):
    """FLOPs of the MHT factorization of an (m, b) panel: per pivot column j
    the tail norm and v (~3 (m - j)), w = tau v^T A and the rank-1 update
    (4 (m - j) per later column); 2 m b^2 - 2/3 b^3 for a tall panel."""
    return sum(4 * (m - j) * (b - j - 1) + 3 * (m - j) for j in range(min(m, b)))


def bound_ms(flops, elems, dtype_name):
    """max(FLOPs / peak, bytes / HBM rate) in ms, and what bounds it.
    The peaks are the H100 SXM data-sheet figures of
    ``repro_torch.launch.roofline`` (the tuner's pruning reads the same):
    the kernels' fp32 work runs as FMA on the CUDA cores, so FP32 SIMT is
    their compute roof."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    itemsize = 4 if dtype_name == "float32" else 8
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = elems * itemsize / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def seeded(torch, shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype)


def compare(torch, got, want, base, width, dtype):
    """max |kernel - plain| against 4 * eps * width * max(1, max |plain|)
    (the kernel checks' bound, width the number of terms the column loop or
    the products carry), and the TF32-rounded control (the kernel's written
    outputs rounded by :func:`round_low`), which must fail it."""
    err, scale = max_err(torch, got, want)
    tol = 4 * float(torch.finfo(dtype).eps) * width * scale
    control = [torch.where(g != b, round_low(torch, g), g) if b is not None
               else round_low(torch, g) for g, b in zip(got, base)]
    control_err = max_err(torch, control, want)[0]
    return dict(max_abs_err=err, tol=tol, control_err=control_err,
                ok=err <= tol < control_err)


def phase_panel_kernels(torch, macro_ops, ops, tile_ops, blocked):
    """The panel path's kernels against their plain versions on the card,
    fp32 and fp64, at the shapes its main paths give them: ``mht_panel``
    on the (60, 576, 32) stack's panels at row0 0 and 160, a (4096, 32)
    panel at row0 0 and 4064, the (8, 6144, 32) TSQR leaves and the wide
    (16, 1000) panel (all on the cluster path), and a (30000, 32) panel
    (the group path); ``wy_trailing`` on those paths' first trailing
    updates (each on the layout ``wy_trailing.layout`` picks) and on a
    (30000, 32) V (the streaming layout); the single-tile ``tsqrt`` /
    ``ssrfb`` entry points.  Then the
    fp32 times of each (CUDA events behind a spin kernel), its plain
    version's and one PyTorch call's (``torch.geqrf`` on the panel,
    ``torch.ormqr`` applying the panel's Q^T, ``torch.geqrf`` on the
    stacked pair, ``torch.ormqr`` on the stacked pair)."""
    from repro_torch.kernels import mht_panel as kpanel

    results, rows = [], {}
    # (30000, 32) is taller than a cluster holds: the group path.
    panels = (((60, 576, 32), 0), ((60, 576, 32), 160), ((4096, 32), 0),
              ((4096, 32), 4064), ((8, 6144, 32), 0), ((16, 1000), 0),
              ((30000, 32), 0))
    for seed, (shape, row0) in enumerate(panels):
        for dtype in (torch.float32, torch.float64):
            a = seeded(torch, shape, 300 + seed, dtype)
            before = macro_ops.LAUNCHES["MHT_PANEL"]
            got = ops.mht_panel(a, row0=row0)
            torch.cuda.synchronize()
            assert macro_ops.LAUNCHES["MHT_PANEL"] == before + 1, "mht_panel"
            packed, taus = macro_ops.panel_body(a, row0)
            want = (packed, taus[..., :got[1].shape[-1]])  # b taus, 0 past m
            torch.cuda.synchronize()
            assert macro_ops.LAUNCHES["MHT_PANEL"] == before + 1
            kf = got[1].shape[-1]   # pivot columns: the loop's length
            res = dict(kernel="MHT_PANEL", shape=list(shape), row0=row0,
                       dtype=str(dtype).replace("torch.", ""), taus=kf,
                       path=kpanel.LAST_GRID["path"],
                       **compare(torch, got, want, (a, None), kf, dtype))
            log("panel kernel check:", json.dumps(res))
            results.append(res)
    from repro_torch.kernels import wy_trailing as ktrail

    # The main paths' first trailing updates, and (30000, 32)·64 for the
    # streaming layout in fp32 (fp64 (8, 6144, 32) streams too).
    traces = ((60, 576, 32, 160), (1, 4096, 32, 4064), (8, 6144, 32, 544),
              (1, 16, 16, 984), (1, 30000, 32, 64))
    for seed, (bsz, m, k, n) in enumerate(traces):
        for dtype in (torch.float32, torch.float64):
            packed, taus = macro_ops.panel_body(
                seeded(torch, (bsz, m, k), 400 + seed, dtype), 0)
            v = blocked.unpack_v_panel(packed, 0)
            t = blocked.larft(v, taus)
            c = seeded(torch, (bsz, m, n), 500 + seed, dtype)
            before = macro_ops.LAUNCHES["WY_TRAILING"]
            got = ops.wy_trailing(v, t, c)
            torch.cuda.synchronize()
            assert macro_ops.LAUNCHES["WY_TRAILING"] == before + 1, "wy_trailing"
            want = macro_ops.wy_body(v, t, c)
            lay = ktrail.layout(m, n, k, bsz, c.element_size())
            assert ktrail.LAST_GRID["layout"] == lay.path, ktrail.LAST_GRID
            res = dict(kernel="WY_TRAILING", shape=[bsz, m, k, n],
                       dtype=str(dtype).replace("torch.", ""),
                       layout=lay.path, cluster=lay.cluster,
                       per_sm=lay.per_sm,
                       **compare(torch, (got,), (want,), (c,), k, dtype))
            log("panel kernel check:", json.dumps(res))
            results.append(res)
    for dtype in (torch.float32, torch.float64):
        r_t = torch.triu(seeded(torch, (NB, NB), 600, dtype))
        a_t = seeded(torch, (NB, NB), 601, dtype)
        got = tile_ops.tsqrt(r_t, a_t)
        want = macro_ops.tsqrt_factor(r_t[None], a_t[None])
        res = dict(kernel="TSQRT_TILE", dtype=str(dtype).replace("torch.", ""),
                   **compare(torch, got, [w[0] for w in want],
                             (r_t, a_t, None), NB, dtype))
        log("panel kernel check:", json.dumps(res))
        results.append(res)
        _, v2, t2, _ = macro_ops.tsqrt_body(r_t[None], a_t[None])
        ck, ci = (seeded(torch, (NB, NB), s_, dtype) for s_ in (602, 603))
        got = tile_ops.ssrfb(v2[0], t2[0], ck, ci)
        want = macro_ops.ssrfb_body(v2, t2, ck[None], ci[None])
        res = dict(kernel="SSRFB_TILE", dtype=str(dtype).replace("torch.", ""),
                   **compare(torch, got, [w[0] for w in want], (ck, ci), NB,
                             dtype))
        log("panel kernel check:", json.dumps(res))
        results.append(res)
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"panel kernel checks failed: {bad}")
    for r in results:
        if r["dtype"] == "float32":
            rows.setdefault(r["kernel"], r)
    rows["MHT_PANEL"] = [r for r in results if r["kernel"] == "MHT_PANEL"
                         and r["shape"] == [4096, 32] and r["row0"] == 0][0]
    rows["WY_TRAILING"] = [r for r in results if r["kernel"] == "WY_TRAILING"
                           and r["shape"] == [1, 4096, 32, 4064]][0]

    # The single-tile entry points' own path: each called once.
    r_t = torch.triu(seeded(torch, (NB, NB), 600, torch.float32))
    a_t = seeded(torch, (NB, NB), 601, torch.float32)
    _, v2, t2, taus2 = macro_ops.tsqrt_body(r_t[None], a_t[None])
    ck, ci = (seeded(torch, (NB, NB), s_, torch.float32) for s_ in (602, 603))
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    tile_ops.tsqrt(r_t, a_t)
    tile_ops.ssrfb(v2[0], t2[0], ck, ci)
    torch.cuda.synchronize()
    tile_launches = launch_counts(macro_ops)
    log("single-tile entry launches:", json.dumps(tile_launches))
    assert tile_launches == {"TSQRT_TILE": 1, "SSRFB_TILE": 1}, tile_launches

    timing = {}
    for shape in ((4096, 32), (60, 576, 32), (8, 6144, 32)):
        base = seeded(torch, shape, 700, torch.float32)
        work = base.clone()
        m, b = shape[-2:]
        bsz = shape[0] if len(shape) == 3 else 1
        flops = bsz * panel_flops(m, b)
        elems = bsz * (2 * m * b + min(m, b))
        timing[str(list(shape))] = dict(
            ms=time_ms(torch, lambda: ops.mht_panel_(work),
                       lambda: work.copy_(base)),
            plain_ms=time_ms(torch, lambda: macro_ops.panel_body(base, 0),
                             reps=3, warmup=1),
            library_ms=time_ms(torch, lambda: torch.geqrf(base)),
            grid=dict(kpanel.LAST_GRID),
            layout=kpanel.layout(m, b)._asdict(),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(flops, elems, "float32"))))
        t = timing[str(list(shape))]
        t["us_per_column"] = t["ms"] * 1e3 / min(m, b)
        log(f"mht_panel {list(shape)}: {t['layout']['path']} path, "
            f"{t['layout']['ctas']} CTAs per panel, "
            f"{t['us_per_column']:.3f} us per column")
    rows["MHT_PANEL"].update(timing["[4096, 32]"], timing_by_shape=timing)
    timing = {}
    for bsz, m, k, n in ((1, 4096, 32, 4064), (60, 576, 32, 160),
                         (8, 6144, 32, 544), (1, 30000, 32, 64)):
        packed, taus = macro_ops.panel_body(
            seeded(torch, (bsz, m, k), 701, torch.float32), 0)
        v = blocked.unpack_v_panel(packed, 0)
        t = blocked.larft(v, taus)
        base = seeded(torch, (bsz, m, n), 702, torch.float32)
        work = base.clone()
        flops = bsz * (4 * m * k * n + 2 * k * k * n)
        elems = bsz * (m * k + k * k + 2 * m * n)
        timing[str([bsz, m, k, n])] = dict(
            ms=time_ms(torch, lambda: ops.wy_trailing_(v, t, work),
                       lambda: work.copy_(base)),
            grid=dict(ktrail.LAST_GRID),
            plain_ms=time_ms(torch, lambda: macro_ops.wy_body(v, t, base),
                             reps=5, warmup=1),
            library_ms=time_ms(torch, lambda: torch.ormqr(
                packed, taus, base, left=True, transpose=True)),
            **dict(zip(("bound_ms", "bound_by"),
                       bound_ms(flops, elems, "float32"))))
        t = timing[str([bsz, m, k, n])]
        log(f"wy_trailing {[bsz, m, k, n]}: {t['grid']['layout']} layout, "
            f"cluster {t['grid']['cluster']}, sized for {t['grid']['per_sm']} "
            f"CTA(s) an SM, {t['grid']['grid']} CTAs, {t['ms']:.5f} ms")
    rows["WY_TRAILING"].update(timing["[1, 4096, 32, 4064]"],
                               timing_by_shape=timing)
    pair = torch.cat([r_t, a_t]).contiguous()
    rows["TSQRT_TILE"].update(
        ms=time_ms(torch, lambda: tile_ops.tsqrt(r_t, a_t)),
        plain_ms=time_ms(torch, lambda: macro_ops.tsqrt_factor(
            r_t[None], a_t[None]), reps=5, warmup=1),
        library_ms=time_ms(torch, lambda: torch.geqrf(pair)),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            2 * NB ** 3, 4 * NB * NB + NB, "float32"))))
    packed2 = torch.cat([torch.zeros_like(v2[0]), v2[0]]).contiguous()
    cpair = torch.cat([ck, ci]).contiguous()
    rows["SSRFB_TILE"].update(
        ms=time_ms(torch, lambda: tile_ops.ssrfb(v2[0], t2[0], ck, ci)),
        plain_ms=time_ms(torch, lambda: macro_ops.ssrfb_body(
            v2, t2, ck[None], ci[None]), reps=5, warmup=1),
        library_ms=time_ms(torch, lambda: torch.ormqr(
            packed2, taus2[0], cpair, left=True, transpose=True)),
        **dict(zip(("bound_ms", "bound_by"), bound_ms(
            FLOPS["SSRFB"](NB), ELEMS["SSRFB"](NB), "float32"))))
    for kind in ("MHT_PANEL", "WY_TRAILING", "TSQRT_TILE", "SSRFB_TILE"):
        log("panel kernel timing:", json.dumps(rows[kind]))
    return rows, tile_launches


def expected_panel_launches(cfg, shape):
    """Launches of the panel path's kernels for one ``qr`` call: a panel
    step is one ``mht_panel`` launch and, where columns trail it, one
    ``wy_trailing`` launch, for the whole stack; Q forms with one
    ``wy_trailing`` launch per panel (``WY_TRAILING_Q``); TSQR runs one
    blocked factorization per tree level, twice with refinement, and
    forms Q by a triangular solve."""
    m, n = shape[-2:]
    k, nb = min(m, n), cfg.block

    def geqrf(rows, cols):
        kk = min(rows, cols)
        steps = range(0, kk, nb)
        return len(steps), sum(j0 + min(nb, kk - j0) < cols for j0 in steps)

    q_panels = -(-k // nb)
    if cfg.method == "geqrf_ht":
        panels, trailing = geqrf(m, n)
        out = dict(MHT_PANEL=panels, WY_TRAILING=trailing,
                   WY_TRAILING_Q=q_panels)
    elif cfg.method == "geqr2_ht":
        out = dict(MHT_PANEL=1, WY_TRAILING=int(n > m), WY_TRAILING_Q=q_panels)
    else:   # tsqr
        levels, p = 1, cfg.nblocks
        while p > 1:
            p = p // 2 + p % 2
            levels += 1
        panels, trailing = geqrf(2 * n, n)
        passes = 2 if cfg.refine else 1
        out = dict(MHT_PANEL=panels * levels * passes,
                   WY_TRAILING=trailing * levels * passes)
    return {key: val for key, val in out.items() if val}


def phase_panel_paths(torch, macro_ops, repro_torch):
    """``repro_torch.qr`` with the default config on the panel path's
    configurations (:data:`PANEL_PATHS`, seeded fp32): the plan takes the
    named route with the kernels, the call launches exactly the expected
    panel and trailing kernels and nothing else, every matrix meets the
    conformance bar, and the result agrees with the plain lowering on the
    card within 4 * sqrt(N) * eps, N = max(m, n) (the lowerings sum in
    different orders: panel kernel vs scaled-norm reflectors, Q by WY
    panels vs one reflector at a time); the plain lowering run with TF32
    products must not.  Timed (median of 5 after a warm-up) beside
    ``torch.linalg.qr``."""
    out = {}
    eps = float(torch.finfo(torch.float32).eps)
    for seed, (label, shape, slug) in enumerate(PANEL_PATHS):
        a = seeded(torch, shape, 800 + seed, torch.float32)
        m, n = shape[-2:]
        solver = repro_torch.plan(a.shape, a.dtype, backend="cuda",
                                  explain=True)
        cfg = solver.config
        log(f"panel path {label} plan:", json.dumps(dict(
            method=cfg.method, use_kernel=cfg.use_kernel, block=cfg.block,
            nblocks=cfg.nblocks,
            decisions=[[d.rule, d.outcome] for d in solver.explain.decisions])))
        assert solver.explain.selected.rule == slug and cfg.use_kernel, cfg
        expected = expected_panel_launches(cfg, shape)

        torch.cuda.synchronize()
        macro_ops.reset_launch_counts()
        q, r = repro_torch.qr(a)
        torch.cuda.synchronize()
        launches = launch_counts(macro_ops)
        log(f"panel path {label} launches:", json.dumps(launches),
            "expected:", json.dumps(expected))

        bar = 100 * eps * max(m, n)
        q64, r64, a64 = q.double(), r.double(), a.double()
        eye = torch.eye(q.shape[-1], dtype=torch.float64, device="cuda")
        ortho = (q64.mT @ q64 - eye).abs().amax(dim=(-2, -1))
        resid = (torch.linalg.matrix_norm(a64 - q64 @ r64)
                 / torch.linalg.matrix_norm(a64))
        plain_cfg = repro_torch.QRConfig(use_kernel=False)
        q0, r0 = repro_torch.qr(a, config=plain_cfg)
        torch.cuda.synchronize()
        plain_launches = launch_counts(macro_ops)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            qc, rc = repro_torch.qr(a, config=plain_cfg)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        # Not every product of a lowering is a GEMM that TF32 reaches, so
        # the control's outputs are rounded to TF32 too.
        qc, rc = round_low(torch, qc), round_low(torch, rc)
        agree_tol = 4 * max(m, n) ** 0.5 * eps
        dq = float((q - q0).abs().max())
        dr = float((r - r0).abs().max() / r0.abs().max())
        dq_ctrl = float((qc - q).abs().max())
        dr_ctrl = float((rc - r).abs().max() / r.abs().max())
        finite = all(bool(torch.isfinite(x).all()) for x in (q, r, q0, r0))
        checks = dict(ortho_max=float(ortho.max()), resid_max=float(resid.max()),
                      bar=bar, matrices_in_bar=int(((ortho <= bar)
                                                     & (resid <= bar)).sum()),
                      dq=dq, dr_rel=dr, agree_tol=agree_tol,
                      tf32_control_dq=dq_ctrl, tf32_control_dr_rel=dr_ctrl,
                      finite=finite, shapes=[list(q.shape), list(r.shape)])
        log(f"panel path {label} checks:", json.dumps(checks))

        def run_qr():
            repro_torch.qr(a)
            torch.cuda.synchronize()

        def run_lib():
            torch.linalg.qr(a)
            torch.cuda.synchronize()

        timing = dict(qr_ms=host_ms(run_qr, reps=5),
                      torch_linalg_qr_ms=host_ms(run_lib, reps=5))
        log(f"panel path {label} timing:", json.dumps(timing))

        nmat = shape[0] if len(shape) == 3 else 1
        assert launches == expected, (label, launches, expected)
        assert plain_launches == launches, "the plain lowering launched kernels"
        assert finite and checks["matrices_in_bar"] == nmat, checks
        assert dq <= agree_tol and dr <= agree_tol, checks
        assert max(dq_ctrl, dr_ctrl) > agree_tol, ("the TF32 control passed",
                                                    checks)
        out[label] = dict(launches=launches, checks=checks, **timing)
    return out


def profile_window(torch, fn):
    """One ``torch.profiler`` trace of ``fn`` (after one untraced session,
    which pays the tracer's start-up): device time of the panel kernel, of
    the trailing kernel and of every other device op, and the union of all
    device intervals over the host wall time (profiling on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return dict(wall_ms_profiled=wall_ms, note="no device events traced")
    # Substrings of the kernels' names: "mht_panel" covers both paths'
    # kernels (mht_panel_cluster_kernel, mht_panel_kernel).
    by = dict(mht_panel=0.0, wy_trailing=0.0, other=0.0)
    for s_, e_, name in spans:
        key = next((k_ for k_ in by if k_ in name), "other")
        by[key] += (e_ - s_) / 1e3
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_, _ in spans[1:]:
        if s_ > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy_us += cur_e - cur_s
    return dict(device_ms=by, device_ops=len(spans), busy_ms=busy_us / 1e3,
                wall_ms_profiled=wall_ms, busy_share_of_wall=busy_us / 1e3 / wall_ms)


def phase_panel_breakdown(torch, repro_torch, blocked):
    """Where the panel path's time goes, at 4096^2 and on the (60, 576,
    192) stack: the factorization and Q formation apart, each on the host
    clock (median of 3) and in one profiled run (panel kernel, trailing
    kernel, other device ops, the device's busy share); and one profiled
    TSQR ``qr`` of 49152 x 576."""
    out = {}
    for label, shape, _ in PANEL_PATHS[:3]:
        a = seeded(torch, shape, 900, torch.float32)
        solver = repro_torch.plan(a.shape, a.dtype, backend="cuda")
        if solver.config.method == "tsqr":
            def run():
                repro_torch.qr(a)
            out[label] = dict(qr_host_ms=host_ms(
                lambda: (run(), torch.cuda.synchronize()), reps=3),
                qr=profile_window(torch, run))
            continue
        packed, taus = solver.factor(a)

        def factor():
            solver.factor(a)

        def form_q():
            blocked.form_q_blocked(packed, taus, block=solver.config.block,
                                   use_kernel=True)
        out[label] = dict(
            factor_host_ms=host_ms(lambda: (factor(), torch.cuda.synchronize()),
                                   reps=3),
            form_q_host_ms=host_ms(lambda: (form_q(), torch.cuda.synchronize()),
                                   reps=3),
            factor=profile_window(torch, factor),
            form_q=profile_window(torch, form_q))
    log("panel path breakdown:", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 13: the QR service on the card
# ---------------------------------------------------------------------------

# benchmarks/bench_qr_serving.py's full mix: 16-request waves, 64^2 to
# 130 x 120, which bucket into 128^2 (10), 96 x 64 (2), 64^2 (2) and
# 160 x 128 (2) under the default policy (tile 32, waste cap 0.25).
SERVICE_MIX = [(128, 128), (128, 128), (120, 110), (96, 64), (128, 128),
               (64, 64), (130, 120), (128, 128)] * 2
SERVICE_WAVES = 8
# One optimizer step's attention momenta of SmolLM-135M
# (src/repro/configs/smollm_135m.py: 30 layers, d_model 576, 3 kv heads
# x 64): the q/o projections (576, 576) and the k/v ones (576, 192).
SMOLLM_MOMENTA = [(576, 576)] * 60 + [(576, 192)] * 60
# What a flush makes of them under the default policy (tile 32, waste cap
# 0.25, max batch 64): each request shape's padded bucket, and each
# bucket's requests, padded batch and rung (the megakernel where its task
# table fits; 768^2's 24 x 24 table does not).  Launches are a wave's:
# one batched megakernel a bucket and one over its Q table, or on the
# wavefront rung one launch per (level, kind) for each filled slice (60 x
# the 24 x 24 schedule's 179, and 93 forming Q).
MIX_PAD = {(128, 128): (128, 128), (120, 110): (128, 128),
           (96, 64): (96, 64), (64, 64): (64, 64), (130, 120): (160, 128)}
MIX_BUCKETS = {"128x128": [10, 16, "megakernel"],
               "96x64": [2, 2, "megakernel"], "64x64": [2, 2, "megakernel"],
               "160x128": [2, 2, "megakernel"]}
MIX_LAUNCHES = {"MEGAKERNEL_BATCHED": 4, "MEGAKERNEL_Q_BATCHED": 4}
SMOLLM_PAD = {(576, 576): (768, 768), (576, 192): (768, 192)}
SMOLLM_BUCKETS = {"768x768": [60, 64, "wavefront"],
                  "768x192": [60, 64, "megakernel"]}
SMOLLM_LAUNCHES = {"GEQRT": 1440, "LARFB": 1380, "TSQRT": 3960,
                   "SSRFB": 3960, "QLARFB": 2820, "QSSRFB": 2760,
                   "MEGAKERNEL_BATCHED": 1, "MEGAKERNEL_Q_BATCHED": 1}
# The plain lowering is held against the service on the first slices of
# each chunk: this many (slices are independent, and the plain lowering,
# a column loop of small ops a GEQRT/TSQRT batch, runs slice by slice at
# ~8 ms a batch on the card), and one for the TF32 control.
PLAIN_SLICES = 2
SERVICE_KINDS = ("GEQRT", "LARFB", "TSQRT", "SSRFB", "QLARFB", "QSSRFB",
                 "MEGAKERNEL", "MEGAKERNEL_BATCHED", "MEGAKERNEL_Q",
                 "MEGAKERNEL_Q_BATCHED")


def wave_of(shapes, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def bucket_groups(wave, pad):
    """``{(m_pad, n_pad): [(index, matrix)]}`` for a wave, by the literal
    shape -> bucket map ``pad`` the checks hold the service to."""
    groups = {}
    for i, a in enumerate(wave):
        groups.setdefault(pad[tuple(a.shape)], []).append((i, a))
    return groups


def plan_buckets(svc, mode="reduced", dtype="float32"):
    """The service's prepared plans of one mode and dtype as ``{bucket:
    [padded batch, rung]}``."""
    return {f"{k.m}x{k.n}": [batch, rung]
            for k, batch, rung in svc._plans
            if k.mode == mode and k.dtype == dtype}


def bar_ratio(torch, wave, results, mode):
    """The worst of each result's conformance measures over its own bar
    ``100 * eps * max(m, n)`` (ratio <= 1 passes): orthogonality and
    residual, or for mode "r" the Gram residual; a non-finite or missing
    result counts as inf."""
    worst = 0.0
    for a, res in zip(wave, results):
        if not res.ok or not torch.isfinite(res.r).all() or (
                res.q is not None and not torch.isfinite(res.q).all()):
            return float("inf")
        a64 = torch.as_tensor(a).to("cuda", torch.float64)
        eps = float(torch.finfo(res.r.dtype).eps)
        bar = 100 * eps * max(a.shape)
        r = res.r.double()
        if mode == "r":
            gram = (torch.linalg.norm(a64.T @ a64 - r.T @ r)
                    / torch.linalg.norm(a64) ** 2)
            worst = max(worst, float(gram) / bar)
            continue
        q = res.q.double()
        eye = torch.eye(q.shape[1], dtype=torch.float64, device="cuda")
        ortho = float((q.T @ q - eye).abs().max())
        resid = float(torch.linalg.norm(a64 - q @ r) / torch.linalg.norm(a64))
        worst = max(worst, ortho / bar, resid / bar)
    return worst


def plain_ratio(torch, tilegraph, groups, results, mode, limit=None,
                tf32=False):
    """The worst disagreement between the service's answers and the plain
    lowering's on the same padded stacks (each bucket's first ``limit``
    requests, :func:`bucket_groups`), over the agreement bound ``4 *
    sqrt(N) * eps``, N the padded max(m, n): max |Q - Q0| and max |R - R0|
    / max |R0|.  With ``tf32`` the plain lowering runs with TF32 products,
    the control that must fail."""
    worst = 0.0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for (mp, np_), part in groups.items():
            part = part[:limit]
            dtype = results[part[0][0]].r.dtype
            stack = torch.zeros((len(part), mp, np_), dtype=dtype,
                                device="cuda")
            for s, (_, a) in enumerate(part):
                stack[s, :a.shape[0], :a.shape[1]] = torch.as_tensor(a)
            out = tilegraph._factor_stack_padded(
                stack, p=mp // NB, q=np_ // NB, nb=NB, mode=mode,
                use_kernel=False)
            torch.cuda.synchronize()
            tol = 4 * max(mp, np_) ** 0.5 * float(torch.finfo(dtype).eps)
            for s, (i, a) in enumerate(part):
                m, n = a.shape
                k = min(m, n)
                r0 = out[-1][s, :k, :n]
                res = results[i]
                dr = float((res.r - r0).abs().max() / r0.abs().max())
                worst = max(worst, dr / tol)
                if mode != "r":
                    dq = float((res.q - out[0][s, :m, :k]).abs().max())
                    worst = max(worst, dq / tol)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return worst


def escalation_counts(metrics):
    """``robustness.escalations`` as {(from, to, reason): count}."""
    fam = metrics.snapshot()["counters"].get("robustness.escalations", [])
    return {(s["labels"]["from"], s["labels"]["to"], s["labels"]["reason"]):
            s["value"] for s in fam}


def counter_delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def serve_waves(torch, svc, waves, mode="reduced"):
    """Serve each wave through ``submit_many``; returns the last wave's
    results and each wave's seconds (a request's latency is its wave's:
    the wave is submitted at once and its flush returns when the card is
    done)."""
    secs, results = [], None
    for w in waves:
        t0 = time.perf_counter()
        results = svc.submit_many(w, mode=mode)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return results, secs


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def service_mix(torch, macro_ops, tilegraph, serving, metrics,
                service_launches):
    """(a) The serving mix: one warm-up wave, 8 timed waves, then one wave
    in mode "r" and one in fp64; the checks and timings of the phase doc."""
    policy = serving.BucketingPolicy()
    svc = serving.QRService(policy=policy)
    esc0 = escalation_counts(metrics)
    serve_waves(torch, svc, [wave_of(SERVICE_MIX, 1000)])
    warm = svc.stats()
    waves = [wave_of(SERVICE_MIX, 1001 + w) for w in range(SERVICE_WAVES)]
    # The last wave's buckets (every wave buckets alike), whose answers
    # the checks hold against the plain lowering.
    groups = bucket_groups(waves[-1], MIX_PAD)
    macro_ops.reset_launch_counts()
    results, secs = serve_waves(torch, svc, waves)
    launches = launch_counts(macro_ops)
    for k, v in launches.items():
        service_launches[k] = service_launches.get(k, 0) + v
    stats = svc.stats()
    expected = {k: v * SERVICE_WAVES for k, v in MIX_LAUNCHES.items()}
    plans = plan_buckets(svc)
    checks = dict(
        buckets={f"{m}x{n}": [len(part)] + plans.get(f"{m}x{n}", [])
                 for (m, n), part in groups.items()},
        plan_builds_after_warmup=stats["compiles"] - warm["compiles"],
        launches=launches, expected=expected,
        bar_ratio=bar_ratio(torch, waves[-1], results, "reduced"),
        plain_ratio=plain_ratio(torch, tilegraph, groups, results,
                                "reduced", limit=PLAIN_SLICES),
        tf32_control_ratio=plain_ratio(torch, tilegraph, groups, results,
                                       "reduced", limit=1, tf32=True))
    total = sum(secs)
    timing = dict(
        wave_ms=[s * 1e3 for s in secs],
        p50_ms=percentile(secs, 50) * 1e3, p99_ms=percentile(secs, 99) * 1e3,
        matrices_per_s=len(SERVICE_MIX) * SERVICE_WAVES / total,
        bucket_fill_ratio=stats["bucket_fill_ratio"],
        cache_hit_rate=stats["cache_hit_rate"])

    # The same requests served one flush per request (each a bucket of
    # one: the single megakernel and its Q table), after a warm-up wave.
    single = serving.QRService(policy=policy)
    for a in wave_of(SERVICE_MIX, 1000):
        single.submit_many([a])
    macro_ops.reset_launch_counts()
    per_req = []
    for w in waves:
        t0 = time.perf_counter()
        for a in w:
            single.submit_many([a])
        torch.cuda.synchronize()
        per_req.append(time.perf_counter() - t0)
    for k, v in launch_counts(macro_ops).items():
        service_launches[k] = service_launches.get(k, 0) + v
    timing.update(per_request_flush_wave_ms=[s * 1e3 for s in per_req],
                  per_request_flush_matrices_per_s=len(SERVICE_MIX)
                  * SERVICE_WAVES / sum(per_req))
    # torch.linalg.qr request by request, each uploaded as the service's.
    lib = []
    for w in [wave_of(SERVICE_MIX, 1000)] + waves:
        t0 = time.perf_counter()
        for a in w:
            torch.linalg.qr(torch.from_numpy(a).cuda())
        torch.cuda.synchronize()
        lib.append(time.perf_counter() - t0)
    lib = lib[1:]
    timing.update(torch_linalg_qr_wave_ms=[s * 1e3 for s in lib],
                  torch_linalg_qr_matrices_per_s=len(SERVICE_MIX)
                  * SERVICE_WAVES / sum(lib))

    # One wave in mode "r" and one in fp64 (their plans build here).
    extra = {}
    for label, wave, mode, want in (
            ("mode_r", wave_of(SERVICE_MIX, 1100), "r",
             {"MEGAKERNEL_BATCHED": 4}),
            ("fp64", wave_of(SERVICE_MIX, 1101, np.float64), "reduced",
             MIX_LAUNCHES)):
        macro_ops.reset_launch_counts()
        res, sec = serve_waves(torch, svc, [wave], mode)
        got = launch_counts(macro_ops)
        for k, v in got.items():
            service_launches[k] = service_launches.get(k, 0) + v
        extra[label] = dict(
            launches=got, expected=want, wave_ms=sec[0] * 1e3,
            plans=plan_buckets(svc, mode, str(wave[0].dtype)),
            bar_ratio=bar_ratio(torch, wave, res, mode),
            plain_ratio=plain_ratio(torch, tilegraph,
                                    bucket_groups(wave, MIX_PAD), res, mode,
                                    limit=PLAIN_SLICES))
    escalated = counter_delta(esc0, escalation_counts(metrics))
    log("service mix checks:", json.dumps(checks))
    log("service mix timing:", json.dumps(timing))
    log("service mix mode r / fp64:", json.dumps(extra))
    assert checks["plan_builds_after_warmup"] == 0, checks
    assert checks["buckets"] == MIX_BUCKETS, checks
    assert launches == expected, checks
    assert checks["bar_ratio"] <= 1 and checks["plain_ratio"] <= 1, checks
    assert checks["tf32_control_ratio"] > 1, ("TF32 control passed", checks)
    for label, e in extra.items():
        assert e["launches"] == e["expected"], (label, e)
        assert e["plans"] == {b: v[1:] for b, v in MIX_BUCKETS.items()}, \
            (label, e)
        assert e["bar_ratio"] <= 1 and e["plain_ratio"] <= 1, (label, e)
    assert not escalated, ("escalations on healthy traffic", escalated)
    return dict(checks=checks, timing=timing, extra=extra)


def service_smollm(torch, macro_ops, tilegraph, serving, metrics,
                   service_launches):
    """(b) One optimizer step's attention momenta of SmolLM-135M as one
    wave of tensors already on the card (an optimizer holds its momenta
    there), after a warm-up wave: a 768^2 bucket of batch 64 on the
    wavefront rung, a 768 x 192 one on the batched megakernel.  The same
    payloads are then served once more from host memory, for the cost of
    their upload."""
    svc = serving.QRService(policy=serving.BucketingPolicy())
    esc0 = escalation_counts(metrics)

    def on_card(seed):
        wave = [torch.from_numpy(a).cuda()
                for a in wave_of(SMOLLM_MOMENTA, seed)]
        torch.cuda.synchronize()
        return wave

    serve_waves(torch, svc, [on_card(2000)])
    warm = svc.stats()["compiles"]
    wave = on_card(2001)
    groups = bucket_groups(wave, SMOLLM_PAD)
    macro_ops.reset_launch_counts()
    results, secs = serve_waves(torch, svc, [wave])
    launches = launch_counts(macro_ops)
    for k, v in launches.items():
        service_launches[k] = service_launches.get(k, 0) + v
    plans = plan_buckets(svc)
    checks = dict(
        buckets={f"{m}x{n}": [len(part)] + plans.get(f"{m}x{n}", [])
                 for (m, n), part in groups.items()},
        padding_waste={f"{m}x{n}": 1.0 - sum(
            a.numel() for _, a in part) / (plans[f"{m}x{n}"][0] * m * n)
            for (m, n), part in groups.items()},
        input_mb=sum(a.numel() * a.element_size() for a in wave) / 1e6,
        plan_builds_after_warmup=svc.stats()["compiles"] - warm,
        launches=launches, expected=SMOLLM_LAUNCHES,
        bar_ratio=bar_ratio(torch, wave, results, "reduced"),
        plain_ratio=plain_ratio(torch, tilegraph, groups, results,
                                "reduced", limit=PLAIN_SLICES),
        tf32_control_ratio=plain_ratio(torch, tilegraph, groups, results,
                                       "reduced", limit=1, tf32=True),
        wave_ms=secs[0] * 1e3)
    host = [a.cpu().numpy() for a in wave]
    _, host_secs = serve_waves(torch, svc, [host])
    checks["wave_ms_from_host"] = host_secs[0] * 1e3
    escalated = counter_delta(esc0, escalation_counts(metrics))
    log("service SmolLM momenta:", json.dumps(checks))
    assert checks["buckets"] == SMOLLM_BUCKETS, checks
    assert checks["plan_builds_after_warmup"] == 0, checks
    assert launches == SMOLLM_LAUNCHES, checks
    assert checks["bar_ratio"] <= 1 and checks["plain_ratio"] <= 1, checks
    assert checks["tf32_control_ratio"] > 1, ("TF32 control passed", checks)
    assert not escalated, ("escalations on healthy traffic", escalated)
    return checks


def service_faults(torch, serving, metrics, inject):
    """(c) One fault of each site on the card, each on a fresh service
    with verification on, with the hops and counters the reference's
    TestServiceChaos expects; then the circuit breaker."""
    wave = wave_of(SERVICE_MIX[:8], 3000)
    cases = [
        ("compile", inject.Fault(site="compile", match="128x128"),
         [("megakernel", "wavefront", "injected_compile")]),
        ("dispatch", inject.Fault(site="dispatch", match="128x128"),
         [("megakernel", "per-request", "injected_dispatch")]),
        ("output", inject.Fault(site="output", match="128x128",
                                slice_index=1),
         [("megakernel", "per-request", "health_check_failed")]),
        ("vmem", inject.Fault(site="vmem", match="megakernel"),
         [("megakernel", "wavefront", "injected_vmem")]),
        ("input", inject.Fault(site="input", match="120x110"), []),
    ]
    out = {}
    for name, fault, hops in cases:
        svc = serving.QRService(verify=True)
        esc0 = escalation_counts(metrics)
        quar0 = metrics.counter_value("robustness.quarantined",
                                      reason="nonfinite_input")
        with inject.active(fault):
            results = svc.submit_many(wave)
        torch.cuda.synchronize()
        got = [(e.rung_from, e.rung_to, e.rule) for e in svc.escalations]
        delta = counter_delta(esc0, escalation_counts(metrics))
        errors = [r.error for r in results if not r.ok]
        clean = [(a, r) for a, r in zip(wave, results) if r.ok]
        out[name] = dict(
            hops=got, fired=fault.fired, errors=errors,
            escalation_counters={"|".join(k): v for k, v in delta.items()},
            quarantined=metrics.counter_value(
                "robustness.quarantined", reason="nonfinite_input") - quar0,
            bar_ratio=bar_ratio(torch, [a for a, _ in clean],
                                [r for _, r in clean], "reduced"),
            stats={k: svc.stats()[k] for k in (
                "escalations", "health_check_failures", "quarantined")})
        assert got == hops, (name, out[name])
        assert delta == {h: 1 for h in hops}, (name, out[name])
        assert fault.fired == 1 and out[name]["bar_ratio"] <= 1, out[name]
        if name == "input":
            assert errors == ["quarantined:nonfinite_input"], out[name]
            assert out[name]["quarantined"] == 1, out[name]
        else:
            assert errors == [], out[name]
    # The breaker: a dispatch fault that stays armed trips it after
    # breaker_threshold escalations of the bucket; the bucket is then
    # served by torch.linalg.qr request by request.
    svc = serving.QRService(verify=True, breaker_threshold=3)
    trips = []
    with inject.active(inject.Fault(site="dispatch",
                                    match="128x128:megakernel", times=None)):
        for w in range(4):
            results = svc.submit_many(wave)
            trips.append(svc.stats()["breaker_trips"])
    torch.cuda.synchronize()
    st = svc.stats()
    out["breaker"] = dict(
        trips_after_each_wave=trips, breaker_open=st["breaker_open"],
        escalations=st["escalations"],
        last_hop=[svc.escalations[-1].rung_from, svc.escalations[-1].rung_to,
                  svc.escalations[-1].rule],
        bar_ratio=bar_ratio(torch, wave, results, "reduced"))
    log("service faults:", json.dumps(out))
    assert trips == [0, 0, 1, 1] and st["breaker_open"] == 1, out["breaker"]
    assert st["escalations"] == 3, out["breaker"]
    assert out["breaker"]["last_hop"] == ["per-request", "lapack",
                                          "breaker_open"], out["breaker"]
    assert out["breaker"]["bar_ratio"] <= 1, out["breaker"]
    return out


def service_verify(torch, repro_torch, metrics):
    """(d) ``qr(a, config=QRConfig(verify=True))`` at 2048^2 and on the
    (60, 576, 576) stack: no escalation, the unverified answer, and the
    cost of verification beside the unverified ``qr``."""
    out = {}
    cfg = repro_torch.QRConfig(verify=True)
    for label, shape in (("2048", (N, N)), ("stack", STACK)):
        a = seeded(torch, shape, 4000, torch.float32)
        esc0 = escalation_counts(metrics)
        q, r = repro_torch.qr(a, config=cfg)
        q0, r0 = repro_torch.qr(a)
        torch.cuda.synchronize()
        out[label] = dict(
            escalations=counter_delta(esc0, escalation_counts(metrics)),
            same_answer=bool(torch.equal(q, q0) and torch.equal(r, r0)),
            qr_ms=host_ms(lambda: (repro_torch.qr(a),
                                   torch.cuda.synchronize()), reps=3),
            verified_qr_ms=host_ms(lambda: (repro_torch.qr(a, config=cfg),
                                            torch.cuda.synchronize()),
                                   reps=3))
    log("service verify:", json.dumps(out))
    for label, v in out.items():
        assert not v["escalations"] and v["same_answer"], (label, v)
    return out


def service_capture(torch, repro_torch, serving, observability):
    """(e) ``observability.capture`` around one warm service wave: the
    exported trace names the ``serving.*`` spans and the megakernel
    labels; and a disabled span costs under 1% of a 2048^2 ``qr``."""
    import tempfile

    svc = serving.QRService()
    wave = wave_of(SERVICE_MIX, 5000)
    svc.submit_many(wave)
    with tempfile.TemporaryDirectory() as logdir:
        with observability.capture(logdir):
            svc.submit_many(wave)
            torch.cuda.synchronize()
        path = os.path.join(logdir, observability.profiler.PROFILE_FILE)
        with open(path) as f:
            doc = json.load(f)
    names = {e.get("name", "") for e in doc.get("traceEvents", [])}
    serving_spans = sorted(n for n in names if n.startswith("serving."))
    mega = sorted(n for n in names if "megakernel[" in n)
    device_kernels = sorted({e.get("name", "")[:40]
                             for e in doc.get("traceEvents", [])
                             if e.get("cat") == "kernel"})
    a = seeded(torch, (N, N), 4001, torch.float32)
    qr_ms = host_ms(lambda: (repro_torch.qr(a), torch.cuda.synchronize()),
                    reps=3)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with observability.span("overhead.probe", mode="megakernel") as sp:
            sp.sync(None)
    span_us = (time.perf_counter() - t0) / n * 1e6
    out = dict(serving_spans=serving_spans, megakernel_labels=mega,
               device_kernels=device_kernels, events=len(names),
               disabled_span_us=span_us, qr_2048_ms=qr_ms,
               span_share_of_qr=span_us / (qr_ms * 1e3),
               capture_errors=observability.metrics.counter_total(
                   "profiler.capture_errors"))
    log("service capture:", json.dumps(out))
    assert {"serving.bucketize", "serving.plan", "serving.dispatch",
            "serving.unpad"} <= set(serving_spans), out
    assert any(m.startswith("megakernel[") for m in mega), out
    assert out["span_share_of_qr"] < 0.01, out
    return out


def phase_service(torch, macro_ops, tilegraph, repro_torch):
    """The QR service on the card (a)-(e); returns the results and the
    launches each kernel made on the service's paths ((a), its
    per-request baseline and (b))."""
    from repro_torch import observability, serving
    from repro_torch.observability import metrics
    from repro_torch.robustness import inject

    service_launches = {}
    parts = (
        ("mix", service_mix, (torch, macro_ops, tilegraph, serving,
                              metrics, service_launches)),
        ("smollm", service_smollm, (torch, macro_ops, tilegraph,
                                    serving, metrics, service_launches)),
        ("faults", service_faults, (torch, serving, metrics, inject)),
        ("verify", service_verify, (torch, repro_torch, metrics)),
        ("capture", service_capture, (torch, repro_torch, serving,
                                      observability)))
    out = {}
    for name, fn, args in parts:
        t0 = time.perf_counter()
        out[name] = fn(*args)
        log(f"service {name}: {time.perf_counter() - t0:.2f} s")
    log("service path launches:", json.dumps(service_launches))
    missing = [k for k in SERVICE_KINDS if not service_launches.get(k)]
    assert not missing, ("kernels the service path never launched", missing)
    return out, service_launches


# ---------------------------------------------------------------------------
# phase 14: QR-Muon training of SmolLM-135M
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ = 8, 512     # the reference launcher's defaults
TRAIN_TIMED = 3                     # timed steps, after one warm-up step
# The kernel run against the plain-lowering run from the same weights and
# batches.  The Muon leaves' change over the first update (the warm-up
# step's LR is 0, so step 2 is the first; both runs see the same
# gradients there), ||P - P_plain|| / ||P_plain - P_start|| (Frobenius
# over the leaves): a control run whose orthogonalization has TF32
# products must fail it.  Each loss after the first update, a coarser
# check: bf16 compute puts a floor of ~5e-5 under any two runs' losses
# that differ at all, and the TF32 control stays under this limit too.
TRAIN_UPDATE_RTOL = 1e-4
TRAIN_LOSS_RTOL = 1e-3
# One step's orthogonalization: three shape classes (key: tall-oriented
# padded shape), their members and routes on the card.
ORTHO_CLASSES = {"576x576": [60, "tiled", "megakernel"],
                 "1536x576": [90, "tiled", "wavefront"],
                 "576x192": [60, "geqrf_ht", None]}
# Launches of one step's orthogonalization: the (60, 18, 18) stack in one
# batched megakernel launch and one over its Q table; the 90 slices of
# the 48 x 18 grid on the wavefront rung, 90 x (18 GEQRT + 17 LARFB + 81
# TSQRT + 79 SSRFB) and 90 x (35 QLARFB + 64 QSSRFB); the (60, 576, 192)
# stack's six panel steps (`expected_panel_launches`).
ORTHO_LAUNCHES = {"MEGAKERNEL_BATCHED": 1, "MEGAKERNEL_Q_BATCHED": 1,
                  "GEQRT": 1620, "LARFB": 1530, "TSQRT": 7290,
                  "SSRFB": 7110, "QLARFB": 3150, "QSSRFB": 5760,
                  "MHT_PANEL": 6, "WY_TRAILING": 5, "WY_TRAILING_Q": 6}


def train_setup(torch):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.training import RunConfig, TrainConfig

    cfg = get_config(TRAIN_ARCH)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=0)
    # One more step than the runs compared: the instrumented one.
    run = RunConfig(total_steps=2 + TRAIN_TIMED, warmup_steps=1,
                    log_every=1, seed=0)
    return cfg, data, run, TrainConfig(optimizer="muon-qr",
                                       batched_ortho=True)


@contextlib.contextmanager
def wrapped_update(wrap):
    """The training step calls ``wrap(muon_update)`` in place of
    ``muon_update`` inside the block."""
    from repro_torch.training import train_step

    real = train_step.muon_update
    train_step.muon_update = wrap(real)
    try:
        yield
    finally:
        train_step.muon_update = real


def recorded_step(torch, trainer):
    """One step of ``trainer`` (timed as :func:`train_steps` times it),
    recording what the step hands ``muon_update``: the clipped gradients,
    the optimizer state and the parameters (cloned, as the step writes
    them in place).  Returns ``(ms, record)``."""
    record = {}

    def recorder(update):
        def run(grads, state, params, **kw):
            record.update(grads=grads, state=state, kw=kw,
                          params={k: p.clone() for k, p in params.items()})
            return update(grads, state, params, **kw)
        return run

    with wrapped_update(recorder):
        ms = train_steps(torch, trainer, 1)
    return ms, record


def tf32_update(torch):
    """A ``wrapped_update`` wrapper: the optimizer step (the
    orthogonalization) with TF32 products, the rest of the step without."""
    def wrap(update):
        def run(*args, **kw):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return update(*args, **kw)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        return run
    return wrap


def ortho_members(dirs):
    """``{class label: [tall-oriented member matrices]}``."""
    out = {}
    for d in dirs.values():
        for mat in d.reshape((-1,) + tuple(d.shape[-2:])):
            mat = mat.mT if mat.shape[0] < mat.shape[1] else mat
            out.setdefault(f"{mat.shape[0]}x{mat.shape[1]}", []).append(mat)
    return out


def qr_backward_error(torch, a, o):
    """Per member, how far ``o`` is from being a thin QR Q of ``a``:
    ``max(||A - O O^T A||_F, ||tril(O^T A, -1)||_F) / ||A||_F`` (fp64).
    A backward-stable QR keeps both near eps whatever A's condition."""
    r = o.mT @ a
    norm = torch.linalg.matrix_norm(a)
    resid = torch.linalg.matrix_norm(a - o @ r) / norm
    tri = torch.linalg.matrix_norm(torch.tril(r, -1)) / norm
    return torch.maximum(resid, tri)


def ortho_runs(torch, leaves):
    """``batched_orthogonalize`` of ``leaves`` on the kernels, by the
    plain lowering on the card, and by the plain lowering with TF32
    products (outputs rounded to TF32: the control)."""
    from repro_torch import QRConfig
    from repro_torch.optim import batched_orthogonalize

    outs = batched_orthogonalize(leaves)
    plain = batched_orthogonalize(leaves, config=QRConfig(use_kernel=False))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctrl = batched_orthogonalize(leaves,
                                     config=QRConfig(use_kernel=False))
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return outs, plain, [round_low(torch, c) for c in ctrl]


def sign_margin(torch, a, o):
    """Per member, the least of ``diag(O^T A)_k / ||a_k||`` over columns
    k: the sign convention of a sign-fixed Q puts every entry at or above
    zero, and a column whose sign is flipped reads ``-|r_kk| / ||a_k||``."""
    d = torch.diagonal(o.mT @ a, dim1=-2, dim2=-1)
    return (d / torch.linalg.vector_norm(a, dim=-2)).amin(-1)


def fp64_q(torch, a):
    """The sign-fixed thin Q of each member by ``torch.linalg.qr`` in
    fp64 (the witness), and ``|r_kk| / ||a_k||`` of its R."""
    q, r = torch.linalg.qr(a)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    q = q * torch.where(d >= 0, 1.0, -1.0).to(q.dtype)[..., None, :]
    return q, d.abs() / torch.linalg.vector_norm(a, dim=-2)


def class_measures(torch, leaves, outs, plain, ctrl):
    """Per class (fp64; N = max(m, n), tol = 4 sqrt(N) eps): the
    kernels' O against the conformance bar, each lowering's backward
    error (:func:`qr_backward_error`) and sign margin
    (:func:`sign_margin`: with the backward error it pins the sign-fixed
    Q), a sign-flip control (the kernels' O with its last column negated),
    the kernels' O against the plain lowering's elementwise, unscaled and
    over ``tol * cond`` of each member's 2-norm condition number, beside
    the TF32 control, and each lowering's distance from the fp64 witness
    (:func:`fp64_q`)."""
    eps = float(torch.finfo(torch.float32).eps)

    def stacks(xs):
        return {k: torch.stack(v).double() for k, v in
                ortho_members(dict(enumerate(xs))).items()}

    got, ref, low, mats = (stacks(outs), stacks(plain), stacks(ctrl),
                           stacks(leaves))
    per_class = {}
    for label, q in got.items():
        m, n = q.shape[-2:]
        tol = 4 * max(m, n) ** 0.5 * eps
        a, q0, qc = mats[label], ref[label], low[label]
        sv = torch.linalg.svdvals(a)
        cond = (sv[:, 0] / sv[:, -1]).clamp(min=1.0)
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        dq = (q - q0).abs().amax(dim=(-2, -1))
        dq_ctrl = (qc - q0).abs().amax(dim=(-2, -1))
        flipped = torch.cat([q[..., :-1], -q[..., -1:]], -1)
        q64, rkk = fp64_q(torch, a)

        def witness(x):
            return (x - q64).abs().amax(dim=(-2, -1))

        w, w0 = witness(q), witness(q0)
        per_class[label] = dict(
            ortho_max=float((q.mT @ q - eye).abs().max()),
            bar=100 * eps * max(m, n), tol=tol,
            backward_error_max=float(qr_backward_error(torch, a, q).max()),
            plain_backward_error_max=float(
                qr_backward_error(torch, a, q0).max()),
            tf32_control_backward_error_max=float(
                qr_backward_error(torch, a, qc).max()),
            sign_margin_min=float(sign_margin(torch, a, q).min()),
            plain_sign_margin_min=float(sign_margin(torch, a, q0).min()),
            flip_control_sign_margin_min=float(
                sign_margin(torch, a, flipped).min()),
            negative_diag_entries=int((torch.diagonal(
                q.mT @ a, dim1=-2, dim2=-1) < 0).sum()),
            columns_signed_beyond_tol=float((rkk > tol).double().mean()),
            dq_max=float(dq.max()), tf32_control_dq_max=float(dq_ctrl.max()),
            cond_max=float(cond.max()), cond_median=float(cond.median()),
            dq_over_cond_tol_max=float((dq / (tol * cond)).max()),
            members_within_unscaled_tol=int((dq <= tol).sum()),
            fp64_witness_max=float(w.max()),
            plain_fp64_witness_max=float(w0.max()),
            tf32_control_fp64_witness_max=float(witness(qc).max()),
            members_kernels_nearer_fp64=int((w <= w0).sum()),
            members=int(q.shape[0]),
            finite=bool(torch.isfinite(q).all()))
    return per_class


def check_classes(per_class):
    """Phase 14's gates on every O of each class (:func:`class_measures`):
    inside the conformance bar, a QR Q of its momentum to ``tol`` in
    backward error (the TF32 control failing it), and the sign convention
    (the sign-flip control failing it)."""
    for label, c in per_class.items():
        assert c["finite"] and c["ortho_max"] <= c["bar"], (label, c)
        assert c["backward_error_max"] <= c["tol"], (label, c)
        assert c["plain_backward_error_max"] <= c["tol"], (label, c)
        assert c["tf32_control_backward_error_max"] > c["tol"], (
            "the TF32 control passed", label, c)
        assert c["sign_margin_min"] >= -c["tol"], (label, c)
        assert c["plain_sign_margin_min"] >= -c["tol"], (label, c)
        assert c["flip_control_sign_margin_min"] < -c["tol"], (
            "the sign-flip control passed", label, c)


def ortho_check(torch, macro_ops, dirs):
    """(a) One step's 210 momenta through ``batched_orthogonalize`` on the
    kernels and through the plain lowering on the card: the plan (3
    classes, 3 dispatches, no leafwise matrix), the literal launches, and
    per class (:func:`class_measures`) every O inside the conformance
    bar, and each lowering's O the sign-fixed QR Q of its momentum: a QR
    Q to ``tol`` in backward error (which does not grow with the
    momentum's condition), with ``diag(O^T A) >= -tol * ||a_k||`` (the
    sign convention, to the same rounding); the TF32 control fails the
    first, the sign-flip control the second.  The step's attention
    momenta reach cond ~1e6, where two backward-stable Q factors differ
    elementwise by up to ~cond x their backward error: the kernels'
    distance from the plain lowering's O, over ``tol * cond``, and each
    lowering's distance from the fp64 witness are readings, not gates.
    Then stacks of the same leaf shapes drawn from a Gaussian through the
    same three calls: the kernels' O within ``tol`` of the plain
    lowering's elementwise, the TF32 control failing that."""
    from repro_torch.optim import plan_batched_ortho

    leaves = list(dirs.values())
    plan = plan_batched_ortho([(tuple(d.shape), d.dtype) for d in leaves],
                              backend="cuda")
    classes = {f"{c.key.m}x{c.key.n}": [len(c.members), c.method,
                                        c.dispatch_mode]
               for c in plan.classes}
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    runs = ortho_runs(torch, leaves)
    launches = launch_counts(macro_ops)
    momenta = class_measures(torch, leaves, *runs)
    gen = torch.Generator(device="cuda").manual_seed(14)
    gauss = [torch.randn(d.shape, generator=gen, device="cuda")
             for d in leaves]
    gaussian = class_measures(torch, gauss, *ortho_runs(torch, gauss))
    checks = dict(classes=classes, dispatches=plan.dispatches,
                  leafwise_matrices=plan.leafwise_matrices,
                  matrices=plan.n_matrices, launches=launches,
                  expected=ORTHO_LAUNCHES, momenta=momenta,
                  gaussian=gaussian)
    log("training ortho checks:", json.dumps(checks))
    assert classes == ORTHO_CLASSES, checks
    assert plan.dispatches == 3 and plan.leafwise_matrices == 0, checks
    assert plan.n_matrices == 210, checks
    assert launches == ORTHO_LAUNCHES, checks
    check_classes(momenta)
    check_classes(gaussian)
    for label, c in gaussian.items():
        assert c["dq_max"] <= c["tol"], (label, c)
        assert c["tf32_control_dq_max"] > c["tol"], (
            "the TF32 control passed", label, c)
    return checks


def ortho_yardsticks(torch, dirs, record):
    """(b) The optimizer alone, on the recorded step's inputs
    (:func:`recorded_step`): ``muon_update`` batched (the kernels) and
    leafwise (``geqrf_fori``, no kernel), and ``torch.linalg.qr`` plus the
    sign fix over the same three stacks; host ms, median of 3."""
    from repro_torch.optim import muon_update

    def update(batched):
        def run():
            muon_update(record["grads"], record["state"], record["params"],
                        **dict(record["kw"], batched_ortho=batched))
            torch.cuda.synchronize()
        return run

    stacks = {label: torch.stack(qs) for label, qs in
              ortho_members(dirs).items()}

    def library():
        for a in stacks.values():
            q, r = torch.linalg.qr(a)
            d = torch.diagonal(r, dim1=-2, dim2=-1)
            q * torch.where(d >= 0, 1.0, -1.0)[..., None, :]
        torch.cuda.synchronize()

    out = dict(batched_optimizer_ms=host_ms(update(True), reps=3),
               leafwise_optimizer_ms=host_ms(update(False), reps=3),
               torch_linalg_qr_ms=host_ms(library, reps=3))
    log("training optimizer yardsticks:", json.dumps(out))
    return out


def step_profile(torch, trainer, tcfg, dirs):
    """A ``torch.profiler`` trace (:func:`profile_window`) of the step's
    two parts: one fwd+bwd on the first batch, and the 1536 x 576 class's
    orthogonalization alone — device busy ms, device ops and busy share
    of the traced wall."""
    from repro_torch.optim import batched_orthogonalize
    from repro_torch.training import train_step

    batch = trainer._place_batch(trainer.pipeline.peek(0))
    big = [d for d in dirs.values() if 1536 in tuple(d.shape[-2:])]

    def fwd_bwd():
        train_step._grads(trainer.state.params, batch, trainer.model_cfg,
                          tcfg)

    out = {}
    for label, fn in (("fwd_bwd", fwd_bwd),
                      ("ortho_1536x576", lambda: batched_orthogonalize(big))):
        w = profile_window(torch, fn)
        out[label] = {k: w[k] for k in ("busy_ms", "device_ops",
                                        "wall_ms_profiled",
                                        "busy_share_of_wall") if k in w}
    log("training profile:", json.dumps(out))
    return out


def train_steps(torch, trainer, n):
    """``n`` steps of ``trainer``, each timed on the host clock around
    the step and a synchronize."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(stop_at=trainer.step_idx + 1)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def instrumented_step(torch, trainer):
    """One more step with the trace on: fwd+bwd, optimizer and each
    class's orthogonalization ms (spans that synchronize the card)."""
    from repro_torch.observability import instrument, trace

    trace.clear()
    with instrument.enabled_scope(tracing=True, annotations=False):
        t0 = time.perf_counter()
        trainer.run(stop_at=trainer.step_idx + 1)
        total = (time.perf_counter() - t0) * 1e3
    spans = trace.spans()
    ms = {s.name: s.duration_us / 1e3 for s in spans
          if s.name in ("train.fwd_bwd", "train.optimizer")}
    ms["per_class"] = {s.labels["bucket"]: s.duration_us / 1e3
                       for s in spans if s.name == "optim.ortho_class"}
    ms["step"] = total
    trace.clear()
    return ms


def params_of(trainer):
    return {k: p.detach().clone()
            for k, p in trainer.state.params.named_parameters()}


def relative_change(torch, p, ref, start, keys):
    """``||P - P_ref|| / ||P_ref - P_start||``, Frobenius over the leaves
    ``keys``."""
    num = sum(float(torch.sum((p[k] - ref[k]).double() ** 2)) for k in keys)
    den = sum(float(torch.sum((ref[k] - start[k]).double() ** 2))
              for k in keys)
    return math.sqrt(num / den)


def plain_run(torch, cfg, tcfg, run, data, start, tf32=False):
    """The same steps from ``start`` (a ``ParamTree``, copied) with the
    orthogonalization on the plain lowering (``tf32``: with TF32 products,
    the control): its losses, its parameters after the first update (step
    2) and after the last step, and its seconds."""
    from repro_torch import QRConfig
    from repro_torch.training import Trainer

    plain_cfg = dataclasses.replace(tcfg, qr_config=QRConfig(use_kernel=False))
    trainer = Trainer(cfg, plain_cfg, run, data, device="cuda", log_fn=log,
                      params=copy.deepcopy(start))
    wrap = tf32_update(torch) if tf32 else (lambda update: update)
    with wrapped_update(wrap):
        t0 = time.perf_counter()
        trainer.run(stop_at=2)
        first = params_of(trainer)
        trainer.run(stop_at=1 + TRAIN_TIMED)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    out = ([m["loss"] for m in trainer.metrics_history], first,
           params_of(trainer), seconds)
    del trainer
    torch.cuda.empty_cache()
    return out


def phase_training(torch, macro_ops):
    """Phase 14: QR-Muon training of SmolLM-135M at full width on the
    card (the port's ``Trainer``, ``TrainConfig(optimizer="muon-qr",
    batched_ortho=True)``, ``SyntheticLM`` at batch 8, sequence 512, seed
    0): the warm-up step, recording what it hands the optimizer; (a) that
    step's 210 momenta (``muon_directions`` of the recorded gradients)
    through the kernels and the plain lowering; (b) three timed steps, an
    instrumented step, the leafwise optimizer and ``torch.linalg.qr``
    beside them; (c) the losses finite, and the losses after the first
    update and the Muon leaves' change over the first update within
    ``TRAIN_LOSS_RTOL`` and ``TRAIN_UPDATE_RTOL`` of a run from the same
    weights and batches whose orthogonalization runs the plain lowering,
    a run with TF32 products in the orthogonalization failing the
    latter.  Returns the results and the launches of the training run
    (the warm-up and timed steps)."""
    from repro_torch.models import param_count
    from repro_torch.optim import is_muon_param, muon_directions
    from repro_torch.training import Trainer

    cfg, data, run, tcfg = train_setup(torch)
    trainer = Trainer(cfg, tcfg, run, data, device="cuda", log_fn=log)
    start_tree = copy.deepcopy(trainer.state.params)
    start = params_of(trainer)
    nparams = param_count(trainer.state.params)
    log("training model:", json.dumps(dict(
        arch=cfg.name, params=nparams, n_layers=cfg.n_layers,
        d_model=cfg.d_model, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, dtype=cfg.dtype)))

    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    step_ms, record = recorded_step(torch, trainer)
    warm_launches = launch_counts(macro_ops)
    _, dirs = muon_directions(record["grads"], record["state"],
                              record["params"],
                              momentum=record["kw"]["momentum"])
    ortho = ortho_check(torch, macro_ops, dirs)
    yard = ortho_yardsticks(torch, dirs, record)
    yard["profile"] = step_profile(torch, trainer, tcfg, dirs)
    del record, dirs
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    step_ms += train_steps(torch, trainer, 1)
    first = params_of(trainer)
    step_ms += train_steps(torch, trainer, TRAIN_TIMED - 1)
    launches = launch_counts(macro_ops)
    losses = [m["loss"] for m in trainer.metrics_history]
    after = params_of(trainer)
    inst = instrumented_step(torch, trainer)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    timed = statistics.median(step_ms[1:])
    timing = dict(step_ms=step_ms, step_ms_median=timed,
                  tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (timed / 1e3),
                  instrumented=inst, peak_memory_gb=peak_gb, **yard)
    log("training timing:", json.dumps(timing))
    del trainer
    torch.cuda.empty_cache()

    plain_losses, plain_first, plain, timing["plain_lowering_run_s"] = (
        plain_run(torch, cfg, tcfg, run, data, start_tree))
    ctrl_losses, ctrl_first, ctrl, timing["tf32_control_run_s"] = plain_run(
        torch, cfg, tcfg, run, data, start_tree, tf32=True)
    muon = [k for k, p in start.items() if is_muon_param(k, p)]

    def loss_rel(xs):
        return [abs(a - b) / abs(b) for a, b in zip(xs, plain_losses)]

    def updates(first_p, last_p):
        """The first update's Muon leaves (the gate), and as readings the
        run's Muon leaves and every leaf."""
        return dict(
            first_update_muon=relative_change(torch, first_p, plain_first,
                                              start, muon),
            run_muon=relative_change(torch, last_p, plain, start, muon),
            run_all=relative_change(torch, last_p, plain, start, start))

    checks = dict(
        losses=losses, plain_losses=plain_losses,
        tf32_control_losses=ctrl_losses, rel_diff=loss_rel(losses),
        tf32_control_rel_diff=loss_rel(ctrl_losses), rtol=TRAIN_LOSS_RTOL,
        update_rel_diff=updates(first, after),
        tf32_control_update_rel_diff=updates(ctrl_first, ctrl),
        update_rtol=TRAIN_UPDATE_RTOL, warmup_launches=warm_launches,
        launches=launches,
        expected={k: TRAIN_TIMED * v for k, v in ORTHO_LAUNCHES.items()})
    del start_tree, start, first, after, plain_first, plain, ctrl_first, ctrl
    torch.cuda.empty_cache()
    log("training loss checks:", json.dumps(checks))
    first_update = checks["update_rel_diff"]["first_update_muon"]
    ctrl_update = checks["tf32_control_update_rel_diff"]["first_update_muon"]
    assert all(math.isfinite(x)
               for x in losses + plain_losses + ctrl_losses), checks
    assert len(losses) == len(plain_losses) == 1 + TRAIN_TIMED, checks
    assert max(checks["rel_diff"][2:]) <= TRAIN_LOSS_RTOL, checks
    assert first_update <= TRAIN_UPDATE_RTOL, checks
    assert ctrl_update > TRAIN_UPDATE_RTOL, (
        "the TF32 control passed", checks)
    assert warm_launches == ORTHO_LAUNCHES, checks
    assert launches == checks["expected"], checks
    return dict(ortho=ortho, timing=timing, losses=checks), {
        k: warm_launches.get(k, 0) + v for k, v in launches.items()}

# ---------------------------------------------------------------------------
# phase 15: DAG analysis and the measured tuning layer
# ---------------------------------------------------------------------------

TUNING_REPS = 3
# Kernels the sweep must launch: the wavefront kernels and the megakernel
# (tiled candidates), the panel kernels (geqrf_ht, geqr2_ht).
TUNING_KERNELS = ("GEQRT", "LARFB", "TSQRT", "SSRFB", "MEGAKERNEL",
                  "MHT_PANEL", "WY_TRAILING")
TUNING_EXTRA = ((200, 200), (640, 640))     # off the class edges


def tuning_dag(dag, mega_row, span_2048_ms):
    """(a) The DAG's tiled depth against the levels the card ran: the
    2048^2 wavefront factorization's dispatched levels and the 640^2
    megakernel table's; beta beside the measured ms per level, and the
    paper's theta curve (readings)."""
    d2048, d640 = dag.analyze_tiled(N, NB), dag.analyze_tiled(N_MEGA, NB)
    out = {
        "2048": dict(depth=d2048.depth, dispatched_levels=DISPATCHED_LEVELS[
            "main path"], ops=d2048.ops, beta=d2048.beta,
            device_ms_per_level=span_2048_ms / d2048.depth),
        "640": dict(depth=d640.depth, megakernel_levels=mega_row["levels"],
                    ops=d640.ops, beta=d640.beta,
                    device_ms_per_level=mega_row["ms_per_level"]),
        "theta": [{k: r[k] for k in ("n", "theta_levels", "theta_width4",
                                     "beta_ht", "beta_mht")}
                  for r in dag.theta_curve()["rows"]],
        "theta_width4_512": dag.phase_model_theta(512)["theta"],
    }
    log("tuning dag:", json.dumps(out))
    assert d2048.depth == out["2048"]["dispatched_levels"], out
    assert d640.depth == mega_row["levels"], out
    return out


def tuned_check(torch, repro_torch, shape, seed):
    """(b) The tuned plan of one class on the card at the class's shape:
    the conformance bar, agreement with its plain lowering within 4
    sqrt(N) eps; the plain lowering with TF32 products, its outputs
    rounded to TF32, must fail the agreement (its bar ratio is a
    reading: the bar leaves a TF32-grade answer 10-300x of room)."""
    a = seeded(torch, shape, seed, torch.float32)
    m, n = shape
    solver = repro_torch.plan(a.shape, a.dtype, backend="cuda", explain=True)
    cfg = solver.config
    assert solver.explain.selected.rule == "tuned", solver.explain
    q, r = solver.solve(a)
    plain = repro_torch.QRConfig(method=cfg.method, block=cfg.block,
                                 use_kernel=False, use_tuning_cache=False)
    q0, r0 = repro_torch.qr(a, config=plain)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        qc, rc = repro_torch.qr(a, config=plain)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    qc, rc = round_low(torch, qc), round_low(torch, rc)
    eps = float(torch.finfo(torch.float32).eps)
    bar = 100 * eps * max(m, n)
    tol = 4 * max(m, n) ** 0.5 * eps

    def conformance(q, r):
        q64, r64, a64 = q.double(), r.double(), a.double()
        eye = torch.eye(q.shape[-1], dtype=torch.float64, device="cuda")
        return (float((q64.T @ q64 - eye).abs().max()),
                float(torch.linalg.norm(a64 - q64 @ r64)
                      / torch.linalg.norm(a64)))

    ortho, resid = conformance(q, r)
    c_ortho, c_resid = conformance(qc, rc)
    out = dict(method=cfg.method, block=cfg.block, use_kernel=cfg.use_kernel,
               dispatch_mode=cfg.dispatch_mode, ortho=ortho, resid=resid,
               bar=bar, dq=float((q - q0).abs().max()),
               dr_rel=float((r - r0).abs().max() / r0.abs().max()),
               agree_tol=tol,
               tf32_control_dq=float((qc - q).abs().max()),
               tf32_control_dr_rel=float((rc - r).abs().max()
                                         / r.abs().max()),
               tf32_control_bar_ratio=max(c_ortho, c_resid) / bar,
               finite=all(bool(torch.isfinite(x).all())
                          for x in (q, r, q0, r0)))
    assert out["finite"] and ortho <= bar and resid <= bar, (shape, out)
    assert out["dq"] <= tol and out["dr_rel"] <= tol, (shape, out)
    assert max(out["tf32_control_dq"], out["tf32_control_dr_rel"]) > tol, (
        "the TF32 control passed", shape, out)
    return out


def tuning_routes(torch, repro_torch, cache, engine, plan_mod):
    """(c) With the fresh cache installed: every swept class plans through
    ``tuned``; C7 keeps the megakernel at 640^2 and on the (60, 576, 576)
    stack unless the 768^2 entry measured both lowerings at its block;
    ``qr`` ms on the auto route with and without the cache (readings)."""
    from repro_torch.tuning.sweep import DEFAULT_SHAPES

    selected = {}
    for m, n in DEFAULT_SHAPES:
        s = repro_torch.plan((m, n), torch.float32, backend="cuda",
                             explain=True)
        selected[f"{m}x{n}"] = [s.explain.selected.rule, s.config.method,
                                s.config.block, s.config.dispatch_mode]
        assert s.explain.selected.rule == "tuned", (m, n, s.explain)
    edge = cache.lookup(backend="cuda", m=768, n=768, dtype=torch.float32)
    decided = plan_mod.tuned_dispatch_mode(edge)
    c7 = {}
    for shape in ((640, 640), STACK):
        s = repro_torch.plan(shape, torch.float32, backend="cuda",
                             explain=True)
        d = s.explain.decision("tuned_config")
        c7["x".join(map(str, shape))] = dict(
            method=s.config.method, block=s.config.block,
            dispatch_mode=s.config.dispatch_mode,
            tuned_config=None if d is None else d.reason)
        if s.config.method == "tiled" and s.config.use_kernel:
            p, q = -(-shape[-2] // s.config.block), -(-shape[-1] // s.config.block)
            want = decided or engine.resolve_dispatch_mode(
                p, q, s.config.block)
            assert s.config.dispatch_mode == want, (shape, c7, decided)
    ms = {}
    for m, n in tuple(DEFAULT_SHAPES) + TUNING_EXTRA:
        a = seeded(torch, (m, n), 1500 + m + n, torch.float32)
        untuned = repro_torch.QRConfig(use_tuning_cache=False)

        def run(cfg=None):
            def go():
                repro_torch.qr(a, config=cfg)
                torch.cuda.synchronize()
            return go

        ms[f"{m}x{n}"] = dict(
            tuned=[repro_torch.plan((m, n), torch.float32).config.method,
                   host_ms(run(), reps=3)],
            heuristic=[repro_torch.plan((m, n), torch.float32,
                                        untuned).config.method,
                       host_ms(run(untuned), reps=3)],
            torch_linalg_qr=host_ms(lambda: (torch.linalg.qr(a),
                                             torch.cuda.synchronize()),
                                    reps=3))
    out = dict(selected=selected, edge_768=edge.best.to_dict(),
               edge_768_timings=edge.timings_dict,
               edge_768_decides=decided, c7=c7, qr_ms=ms)
    log("tuning routes:", json.dumps(out))
    return out


def tuning_service(torch, serving, inject, engine, plan_mod, macro_ops,
                   cache):
    """(d) A warm service on the card with an open breaker; installing
    the fresh cache drops its plans once (``plan_invalidations`` 1) and
    resets the breaker.  A bucket's first rung follows an entry only
    where :func:`repro_torch.core.plan.tuned_dispatch_mode` decides one
    (the entry measured both lowerings at the service's tile), else the
    engine's budget rule: the 768^2 bucket reports which of the two
    decided; at 512^2 (16 x 16 tiles, the megakernel fits) an entry
    built from the sweep's own 512^2 timings, its pick set to the
    wavefront lowering, must move a served request off the megakernel,
    which it runs without that entry."""
    import dataclasses

    from repro_torch.tuning import TunedConfig, TuningCache, set_active_cache

    set_active_cache(None)                     # the default: no cache
    svc = serving.QRService(verify=True, breaker_threshold=1)
    wave = wave_of([(128, 128), (120, 110), (96, 64), (700, 700)], 3100)
    with inject.active(inject.Fault(site="dispatch", match="128x128")):
        svc.submit_many(wave)
    svc.submit_many(wave)                      # warm: plans cached
    before = svc.stats()
    assert before["breaker_open"] == 1 and before["plans_cached"] > 0, before
    set_active_cache(cache)
    results = svc.submit_many(wave)
    after = svc.stats()
    svc.submit_many(wave)
    steady = svc.stats()
    nb = svc.policy.tile

    def bucket(e):
        return serving.BucketKey(e, e, "float32", "reduced")

    def decides(entry):
        return (plan_mod.tuned_dispatch_mode(entry)
                if entry is not None and entry.best.block == nb else None)

    e768 = cache.lookup(backend="cuda", m=768, n=768, dtype=torch.float32)
    rung_768 = svc._initial_rung(bucket(768))
    want_768 = decides(e768) or engine.resolve_dispatch_mode(
        768 // nb, 768 // nb, nb)
    e512 = cache.lookup(backend="cuda", m=512, n=512, dtype=torch.float32)
    timed = e512.timings_dict
    labels = [f"tiled[b{nb},{mode}]" for mode in ("wavefront", "megakernel")]
    assert all(k in timed for k in labels), (labels, timed)
    wave_pick = dataclasses.replace(
        e512, best=TunedConfig(method="tiled", block=nb,
                               dispatch_mode="wavefront", use_kernel=True),
        best_us=timed[labels[0]])
    assert decides(wave_pick) == "wavefront"
    others = [e for e in cache.entries() if e.key != e512.key]
    a512 = wave_of([(512, 512)], 3200)
    served = {}
    for label, c in (("without_entry", TuningCache(others)),
                     ("entry_picks_wavefront",
                      TuningCache(others + [wave_pick]))):
        set_active_cache(c)
        macro_ops.reset_launch_counts()
        res = svc.submit_many(a512)
        torch.cuda.synchronize()
        served[label] = dict(rung=svc._initial_rung(bucket(512)),
                             launches=launch_counts(macro_ops),
                             ok=res[0].ok,
                             bar_ratio=bar_ratio(torch, a512, res, "reduced"))
    set_active_cache(cache)
    out = dict(
        before={k: before[k] for k in ("plans_cached", "breaker_open",
                                       "plan_invalidations")},
        after={k: after[k] for k in ("plans_cached", "breaker_open",
                                     "plan_invalidations", "breaker_resets",
                                     "cache_evictions")},
        steady_invalidations=steady["plan_invalidations"],
        bucket_768=dict(rung=rung_768, entry=e768.best.to_dict(),
                        decided_by="entry" if decides(e768) else
                        "budget rule"),
        bucket_512=served,
        bar_ratio=bar_ratio(torch, wave, results, "reduced"))
    log("tuning service:", json.dumps(out))
    assert after["plan_invalidations"] == 1 == steady["plan_invalidations"], out
    assert after["breaker_open"] == 0 and after["breaker_resets"] == 1, out
    assert all(r.ok for r in results) and out["bar_ratio"] <= 1, out
    assert rung_768 == want_768, out
    without, with_ = served["without_entry"], served["entry_picks_wavefront"]
    mega = ("MEGAKERNEL", "MEGAKERNEL_BATCHED")
    assert without["rung"] == "megakernel" and any(
        without["launches"].get(k) for k in mega), out
    assert with_["rung"] == "wavefront" and not any(
        with_["launches"].get(k) for k in mega) and with_["launches"].get(
        "SSRFB"), out
    assert all(v["ok"] and v["bar_ratio"] <= 1 for v in served.values()), out
    return out


def phase_tuning(torch, macro_ops, repro_torch, mega_row, span_2048_ms):
    """Phase 15: the DAG cross-check, the sweep over the card's classes
    (its launches counted), the ``tuned`` rule with the fresh cache, the
    service's invalidation; the active cache restored in a ``finally``."""
    import importlib
    import tempfile

    from repro_torch import serving
    from repro_torch.core import dag, engine
    from repro_torch.robustness import inject
    from repro_torch.tuning import TuningCache, set_active_cache
    from repro_torch.tuning import sweep

    plan_mod = importlib.import_module("repro_torch.core.plan")
    out = dict(dag=tuning_dag(dag, mega_row, span_2048_ms))
    try:
        torch.cuda.synchronize()
        macro_ops.reset_launch_counts()
        t0 = time.perf_counter()
        fresh = sweep.sweep_shapes(sweep.DEFAULT_SHAPES, dtype=torch.float32,
                                   reps=TUNING_REPS, device="cuda")
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = launch_counts(macro_ops)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "tuning.json")
            fresh.save(path)
            cache = TuningCache.load(path)
        classes = {f"{e.shape_class[0]}x{e.shape_class[1]}": dict(
            best=[e.best.method, e.best.block, e.best.dispatch_mode,
                  e.best.use_kernel],
            best_us=e.best_us, heuristic=e.heuristic_method,
            heuristic_us=e.heuristic_us, timings_us=e.timings_dict)
            for e in cache.entries()}
        problems = sweep.check_cache(cache)
        log("tuning sweep:", json.dumps(dict(
            seconds=sweep_s, reps=TUNING_REPS, classes=classes,
            problems=problems, launches=launches)))
        want = {"x".join(map(str, sweep.shape_class(*s)))
                for s in sweep.DEFAULT_SHAPES}
        assert set(classes) == want and len(want) == 8, (classes, want)
        assert problems == [], problems
        missing = [k for k in TUNING_KERNELS if not launches.get(k)]
        assert not missing, ("kernels the sweep did not launch", missing)
        set_active_cache(cache)
        out["conformance"] = {
            f"{m}x{n}": tuned_check(torch, repro_torch, (m, n), 1400 + i)
            for i, (m, n) in enumerate(sweep.DEFAULT_SHAPES)}
        log("tuning conformance:", json.dumps(out["conformance"]))
        out["routes"] = tuning_routes(torch, repro_torch, cache, engine,
                                      plan_mod)
        out["service"] = tuning_service(torch, serving, inject, engine,
                                        plan_mod, macro_ops, cache)
    finally:
        set_active_cache(None)
    d = repro_torch.plan((N_MEGA, N_MEGA), torch.float32,
                         explain=True).explain.decision("tuned")
    assert d.reason.startswith("no tuning cache loaded"), d
    out.update(sweep_seconds=sweep_s, classes=classes)
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: the distributed QR layer, checkpoint/restart, compression
# ---------------------------------------------------------------------------

DIST_N = 4096                 # the 4096^2 cell one process sends to geqrf_ht
DIST_BLOCK = 64               # the tile _resolve_sharded grows it to
DIST_TSQR = (49152, 576)      # the TSQR cell, 12,288 rows a rank at d = 4
DIST_PSUM = 1_000_000         # elements a rank contributes to compressed_psum
DIST_REPS = 3
DIST_TIMEOUT_S = 300          # every collective of a rank ends within this
RESTART_LOSS_ATOL = 1e-3      # the reference's restart bar
COMPRESSION_LOSS_RTOL = 5e-2


def sha(torch, x):
    import hashlib

    return hashlib.sha256(x.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def qr_gates(torch, a, q, r):
    """The conformance bar (100 eps N) and the tight backward-error gate
    (4 sqrt(N) eps) on ||Q^T Q - I||_max and ||A - QR||_F / ||A||_F, for
    ``(q, r)`` and for a TF32-grade control (both rounded to TF32), which
    the bar cannot tell apart at these sizes and the tight gate must."""
    eps = float(torch.finfo(torch.float32).eps)
    m, n = a.shape
    a64 = a.double()
    norm_a = float(torch.linalg.norm(a64))
    eye = torch.eye(q.shape[1], dtype=torch.float64, device=a.device)

    def measures(qq, rr):
        q64, r64 = qq.double(), rr.double()
        return (float((q64.T @ q64 - eye).abs().max()),
                float(torch.linalg.norm(a64 - q64 @ r64)) / norm_a)

    ortho, resid = measures(q, r)
    c_ortho, c_resid = measures(round_low(torch, q), round_low(torch, r))
    bar, tight = 100 * eps * max(m, n), 4 * max(m, n) ** 0.5 * eps
    finite = bool(torch.isfinite(q).all() and torch.isfinite(r).all())
    return dict(ortho=ortho, resid=resid, bar=bar, tight=tight,
                tf32_control_ortho=c_ortho, tf32_control_resid=c_resid,
                finite=finite, triangular=float(torch.tril(
                    r[:, :min(m, n)], -1).abs().max()) == 0.0,
                ok=(finite and max(ortho, resid) <= tight <= bar
                    and max(c_ortho, c_resid) > tight))


def r_vs_fp64(torch, a, r):
    """max |R - R64 diag(s)| over max |R64|: R against fp64
    ``torch.linalg.qr`` up to the column signs s."""
    r64 = torch.linalg.qr(a.double(), mode="r")[1]
    s = torch.sign(torch.diagonal(r.double())) * torch.sign(
        torch.diagonal(r64))
    return float((r.double() * s[:, None] - r64).abs().max()
                 / r64.abs().max())


def barrier_ms(torch, dist, fn, reps=DIST_REPS):
    """Host ms of ``fn`` per run, median of ``reps`` after a warm-up, each
    run started together on every rank (a barrier) and ended by a
    synchronize."""
    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def traced_shares(torch, fn):
    """``fn()`` once with the trace on (spans that synchronize the card):
    its host ms, the ms of its domain sweeps, merges and collectives (by
    op), and the merge's and the collectives' shares of the call."""
    from repro_torch.observability import instrument, trace

    trace.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with instrument.enabled_scope(tracing=True, annotations=False):
        fn()
        torch.cuda.synchronize()
    total = (time.perf_counter() - t0) * 1e3
    spans = trace.spans()
    trace.clear()
    ms = lambda name: sum(s.duration_us for s in spans if s.name == name) / 1e3
    by_op = {}
    for s in spans:
        if s.name == "distributed.collective":
            by_op[s.labels["op"]] = by_op.get(s.labels["op"], 0.0) \
                + s.duration_us / 1e3
    merge = ms("tsqr.butterfly_merge_r")
    return dict(total_ms=total, sweep_ms=ms("distgraph.domain_r"),
                merge_ms=merge, collective_ms=by_op,
                merge_share=merge / total,
                collective_share=sum(by_op.values()) / total)


def sharded_launches(engine, p_dom, q, mode, n, d, passes):
    """One sharded ``qr``'s launches on a computing rank: each domain
    sweep's wavefront (or megakernel) launches, once per pass, and each
    merge's combine, a blocked panel-path QR of a (2n, n) stack at block
    32 (one ``mht_panel`` a panel, one ``wy_trailing`` where columns
    trail it), log2(d) rounds a pass."""
    out = {k: v * passes for k, v in
           engine.dispatch_counts(p_dom, q, mode).items() if v}
    panels = -(-n // 32)
    rounds = (d - 1).bit_length() * passes
    out.update(MHT_PANEL=panels * rounds, WY_TRAILING=(panels - 1) * rounds)
    return out


def rank_sharded(torch, dist, rank, world):
    """(a) ``repro_torch.qr(a)`` on a seeded 4096^2 fp32 matrix through
    the auto route on ``world`` ranks: its plan, launches, gates, R against
    fp64 (rank 0), the bits of Q and R, timing, and one traced call."""
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.kernels import macro_ops

    from repro_torch.distributed import sharding

    rng = np.random.default_rng(DIST_N)
    a = torch.from_numpy(rng.standard_normal((DIST_N, DIST_N)).astype(
        np.float32)).cuda()
    # A rank's own qr counts the group's ranks only on the opt-in (C10).
    opt_in = repro_torch.QRConfig(ndomains=world)
    solver = repro_torch.plan(a.shape, a.dtype, opt_in, backend="cuda",
                              explain=True)
    cfg = solver.config
    plan = dict(method=cfg.method, block=cfg.block, ndomains=cfg.ndomains,
                dispatch_mode=cfg.dispatch_mode, use_kernel=cfg.use_kernel,
                q_method=cfg.q_method,
                decisions=[[x.rule, x.outcome] for x in
                           solver.explain.decisions])
    assert solver.explain.selected.rule == "sharded_past_ceiling", plan
    assert (cfg.method, cfg.ndomains, cfg.block, cfg.use_kernel) == (
        "sharded_tiled", world, DIST_BLOCK, True), plan
    repro_torch.qr(a, config=opt_in)
    torch.cuda.synchronize()
    dist.barrier()
    macro_ops.reset_launch_counts()
    q, r = repro_torch.qr(a, config=opt_in)
    torch.cuda.synchronize()
    launches = launch_counts(macro_ops)
    p_dom = -(-DIST_N // cfg.block) // world
    expected = sharded_launches(engine, p_dom, DIST_N // cfg.block,
                                cfg.dispatch_mode, DIST_N, world, passes=2)
    gates = qr_gates(torch, a, q, r)
    out = dict(plan=plan, launches=launches, expected=expected, gates=gates,
               q_sha=sha(torch, q), r_sha=sha(torch, r))
    if rank == 0:
        out["r_vs_fp64"] = r_vs_fp64(torch, a, r)
    del q, r
    out["qr_ms"], out["qr_ms_all"] = barrier_ms(
        torch, dist, lambda: repro_torch.qr(a, config=opt_in))
    out["spans"] = traced_shares(torch,
                                 lambda: repro_torch.qr(a, config=opt_in))
    out["fingerprint_ms"], _ = barrier_ms(
        torch, dist, lambda: sharding.check_same_copies(a, None))
    return out


def rank_tsqr(torch, dist, rank, world):
    """(b) ``distributed_qr`` of a seeded 49152 x 576 fp32 matrix, rank i
    holding rows i x 12,288 on (the kernels on every leaf and merge)."""
    from repro_torch.core import tsqr
    from repro_torch.distributed import sharding
    from repro_torch.kernels import macro_ops

    m, n = DIST_TSQR
    rows = m // world
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.standard_normal((m, n)).astype(
        np.float32)).cuda()
    mine = a[rank * rows:(rank + 1) * rows]

    def run():
        return tsqr.distributed_qr(mine, None, use_kernel=True)

    run()
    torch.cuda.synchronize()
    dist.barrier()
    macro_ops.reset_launch_counts()
    q_local, r = run()
    torch.cuda.synchronize()
    launches = launch_counts(macro_ops)
    # Two trees (CQR2), each the leaf's blocked QR and log2(world) merges,
    # every one over n columns at block 32.
    panels, trees = -(-n // 32), 2 * (1 + (world - 1).bit_length())
    expected = dict(MHT_PANEL=trees * panels, WY_TRAILING=trees * (panels - 1))
    q = sharding.all_gather_rows(q_local, None)
    gates = qr_gates(torch, a, q, r)
    out = dict(launches=launches, expected=expected, gates=gates,
               q_sha=sha(torch, q), r_sha=sha(torch, r), rows=rows)
    if rank == 0:
        out["r_vs_fp64"] = r_vs_fp64(torch, a, r)
    del q, q_local, r
    out["qr_ms"], out["qr_ms_all"] = barrier_ms(torch, dist, run)
    out["spans"] = traced_shares(torch, run)
    return out


def rank_psum(torch, dist, rank, world):
    """(c) ``compressed_psum`` of one seeded 1e6-element fp32 vector a
    rank: the mean against the mean of every rank's decoded contribution
    (fp32 rounding) and against the true mean (1/127 of each block's
    largest magnitude over the ranks)."""
    from repro_torch.distributed import compressed_psum, dequantize, quantize

    g = [torch.from_numpy(np.random.default_rng(1600 + i).standard_normal(
        DIST_PSUM).astype(np.float32)).cuda() for i in range(world)]
    zero = torch.zeros_like(g[rank])

    def run():
        return compressed_psum({"g": g[rank]}, None, {"g": zero})

    red, err = run()
    got = red["g"]
    dec = torch.stack([dequantize(*quantize(x), x.shape) for x in g])
    mean_dec = dec.mean(0)
    true = torch.stack(g).mean(0)
    pad = (-DIST_PSUM) % 256
    blockmax = torch.nn.functional.pad(torch.stack(g).abs().amax(0), (0, pad)
                                       ).reshape(-1, 256).amax(1)
    bound = (blockmax / 127).repeat_interleave(256)[:DIST_PSUM]
    eps = float(torch.finfo(torch.float32).eps)
    out = dict(
        vs_decoded=float((got - mean_dec).abs().max()),
        decoded_tol=4 * eps * float(mean_dec.abs().max()),
        vs_true_over_bound=float(((got - true).abs() / bound).max()),
        residual_exact=bool(torch.equal(err["g"], g[rank] - dec[rank])),
        sha=sha(torch, got))
    out["ms"], out["ms_all"] = barrier_ms(torch, dist, run)
    return out


RANK_JOBS = {"sharded": rank_sharded, "tsqr": rank_tsqr, "psum": rank_psum}


def rank_main(rank, world, store, outdir, jobs):
    """One rank of phase 16, in a process of its own (``spawn``: nothing of
    the parent's state is inherited): the TF32 flags off, the card, a gloo
    group through a ``file://`` store (ranks that share one card cannot
    use NCCL), the kernel library the parent built, then ``jobs`` in
    order; writes ``rank<i>.json`` to ``outdir``."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    from repro_torch.kernels import _build

    _build.library()
    dist.init_process_group(
        "gloo", init_method="file://" + store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    out = {job: RANK_JOBS[job](torch, dist, rank, world) for job in jobs}
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(world, jobs):
    """Run ``jobs`` on ``world`` spawned ranks; raises when any rank fails
    (``torch.multiprocessing`` then ends the others).  Returns each rank's
    results."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        mp.start_processes(rank_main, args=(world, os.path.join(tmp, "store"),
                                            tmp, jobs),
                           nprocs=world, join=True, start_method="spawn")
        outs = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                outs.append(json.load(f))
        return outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_cell(label, cells):
    """Every rank's gates and launches (each kernel of the cell's path
    launched, the expected number of times), the same bits on every rank,
    R against fp64 on rank 0."""
    for i, c in enumerate(cells):
        assert c["gates"]["ok"], (label, i, c["gates"])
        assert c["gates"]["triangular"], (label, i)
        assert c["launches"] == c["expected"], (label, i, c["launches"],
                                                c["expected"])
        assert all(c["expected"].values()) and {
            "MHT_PANEL", "WY_TRAILING"} <= set(c["expected"]), c["expected"]
    assert len({c["r_sha"] for c in cells}) == 1, (label, "R differs")
    assert len({c["q_sha"] for c in cells}) == 1, (label, "Q differs")
    assert cells[0]["r_vs_fp64"] <= cells[0]["gates"]["bar"], cells[0]


def restart_leaves(trainer):
    from repro_torch.checkpoint.manager import _leaves_with_path

    return [(k, x.detach().clone() if hasattr(x, "detach") else x)
            for k, x in _leaves_with_path(trainer.checkpoint_tree())]


def phase_restart(torch, macro_ops):
    """(d) SmolLM-135M at full width (phase 14's configuration) on the
    card: trainer A runs to step 3 of 4 saving every 2 (a crash after
    step 3), B restores and runs step 4, C runs the 4 steps without a
    break; (e) 3 steps with ``grad_compression`` from the same weights.
    The checkpoints live under ``$TMPDIR`` and are removed."""
    import shutil
    import tempfile

    from repro_torch.observability import instrument, trace
    from repro_torch.training import RunConfig, Trainer

    cfg, data, _, tcfg = train_setup(torch)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {}
    try:
        run = RunConfig(total_steps=4, warmup_steps=1, log_every=1,
                        checkpoint_every=2, checkpoint_dir=ckdir, seed=0)
        a = Trainer(cfg, tcfg, run, data, device="cuda", log_fn=log)
        start = copy.deepcopy(a.state.params)
        torch.cuda.synchronize()
        macro_ops.reset_launch_counts()
        a.run(stop_at=3)
        torch.cuda.synchronize()
        launches = launch_counts(macro_ops)
        saved = restart_leaves(a)
        cursor = a.pipeline.state_dict()
        assert a.ckpt.all_steps() == [2, 3], a.ckpt.all_steps()
        t0 = time.perf_counter()
        a._save(blocking=False)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        a.ckpt.wait_until_finished()
        write_s = time.perf_counter() - t0 - snapshot_ms / 1e3
        step_dir = os.path.join(ckdir, "step_00000003")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        del a
        torch.cuda.empty_cache()

        b = Trainer(cfg, tcfg, run, data, device="cuda", log_fn=log)
        t0 = time.perf_counter()
        assert b.maybe_restore() and b.step_idx == 3, b.step_idx
        restore_s = time.perf_counter() - t0
        got = restart_leaves(b)
        assert [k for k, _ in got] == [k for k, _ in saved]
        unequal = [k for (k, x), (_, y) in zip(got, saved)
                   if not (torch.equal(x, y) if hasattr(x, "dtype")
                           else x == y)]
        cursor_ok = b.pipeline.state_dict() == cursor
        nleaves = len(saved)
        del saved, got
        b.run(resume=False)
        loss_b = b.metrics_history[-1]["loss"]
        p_b = params_of(b)
        del b
        torch.cuda.empty_cache()

        c = Trainer(cfg, tcfg, RunConfig(total_steps=4, warmup_steps=1,
                                         log_every=1, seed=0),
                    data, device="cuda", log_fn=log,
                    params=copy.deepcopy(start))
        c.run()
        losses_c = [m["loss"] for m in c.metrics_history]
        p_c = params_of(c)
        max_param_diff = max(float((p_b[k] - p_c[k]).abs().max())
                             for k in p_c)
        del c, p_b, p_c
        torch.cuda.empty_cache()
        out["restart"] = dict(
            checkpoint_bytes=nbytes, snapshot_ms=snapshot_ms,
            write_s=write_s, restore_s=restore_s, leaves=nleaves,
            unequal_leaves=unequal, cursor=cursor, cursor_ok=cursor_ok,
            loss_b=loss_b, loss_c=losses_c[-1], losses_c=losses_c,
            loss_diff=abs(loss_b - losses_c[-1]),
            max_param_diff=max_param_diff, launches=launches)
        log("restart:", json.dumps(out["restart"]))
        assert not unequal and cursor_ok, out["restart"]
        assert out["restart"]["loss_diff"] < RESTART_LOSS_ATOL, out["restart"]

        e = Trainer(cfg, dataclasses.replace(tcfg, grad_compression=True),
                    RunConfig(total_steps=4, warmup_steps=1, log_every=1,
                              seed=0),
                    data, device="cuda", log_fn=log, params=start)
        trace.clear()
        with instrument.enabled_scope(tracing=True, annotations=False):
            e.run(stop_at=3)
        codec = [s.duration_us / 1e3 for s in trace.spans()
                 if s.name == "train.grad_compression"]
        trace.clear()
        losses_e = [m["loss"] for m in e.metrics_history]
        rel = [abs(x - y) / abs(y) for x, y in zip(losses_e, losses_c)]
        del e, start
        torch.cuda.empty_cache()
        out["compression"] = dict(losses=losses_e, uncompressed=losses_c[:3],
                                  rel_diff=rel, codec_ms=codec,
                                  rtol=COMPRESSION_LOSS_RTOL)
        log("compression:", json.dumps(out["compression"]))
        assert len(losses_e) == 3 and len(codec) == 3, out["compression"]
        assert all(math.isfinite(x) for x in losses_e), out["compression"]
        assert max(rel) <= COMPRESSION_LOSS_RTOL, out["compression"]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return out


def phase_distributed(torch, macro_ops, repro_torch):
    """Phase 16: the sharded tiled QR at d = 2 and d = 4 ranks (one card
    time-shared by spawned gloo ranks: correctness and cost, not
    scaling), ``distributed_qr`` at d = 4, ``compressed_psum`` over 2
    ranks, then checkpoint/restart and gradient compression in this
    process.  Returns the results and each rank's launches per cell."""
    two = spawn_ranks(2, ["sharded", "psum"])
    four = spawn_ranks(4, ["sharded", "tsqr"])
    cells = {"4096_d2": [o["sharded"] for o in two],
             "4096_d4": [o["sharded"] for o in four],
             "tsqr_d4": [o["tsqr"] for o in four]}
    for label, c in cells.items():
        check_cell(label, c)
    psum = [o["psum"] for o in two]
    for p in psum:
        assert p["vs_decoded"] <= p["decoded_tol"], psum
        assert p["vs_true_over_bound"] <= 1.0 and p["residual_exact"], psum
    assert len({p["sha"] for p in psum}) == 1, psum

    a = torch.from_numpy(np.random.default_rng(DIST_N).standard_normal(
        (DIST_N, DIST_N)).astype(np.float32)).cuda()
    t = torch.from_numpy(np.random.default_rng(DIST_TSQR[0]).standard_normal(
        DIST_TSQR).astype(np.float32)).cuda()

    def ms(fn):
        return host_ms(lambda: (fn(), torch.cuda.synchronize()), DIST_REPS)

    beside = dict(torch_linalg_qr_4096_ms=ms(lambda: torch.linalg.qr(a)),
                  qr_4096_one_process_ms=ms(lambda: repro_torch.qr(a)),
                  torch_linalg_qr_tsqr_ms=ms(lambda: torch.linalg.qr(t)),
                  qr_tsqr_one_process_ms=ms(lambda: repro_torch.qr(t)))
    del a, t
    torch.cuda.empty_cache()
    summary = {label: dict(
        qr_ms=[c["qr_ms"] for c in outs], launches=[c["launches"] for c in outs],
        gates=outs[0]["gates"], r_vs_fp64=outs[0]["r_vs_fp64"],
        spans=[c["spans"] for c in outs],
        plan=outs[0].get("plan"),
        fingerprint_ms=[c.get("fingerprint_ms") for c in outs])
        for label, outs in cells.items()}
    summary["psum"] = psum
    summary["beside"] = beside
    log("distributed:", json.dumps(summary))
    out = dict(cells=summary, **phase_restart(torch, macro_ops))
    launches = {label: [c["launches"] for c in outs]
                for label, outs in cells.items()}
    launches["restart_training"] = out["restart"]["launches"]
    return out, launches


# ---------------------------------------------------------------------------
# phase 17: mesh training
# ---------------------------------------------------------------------------

MESH_RANKS = 2                # 17(b): data-parallel ranks sharing the card
MESH_LOSS_RTOL = 1e-3         # losses against the run each is held to
MESH_UPDATE_RTOL = 1e-4       # the Muon leaves' update against its reference
MESH_DIR_ENV = "CHIP_SMOKE_MESH_DIR"     # phase 17's files: 17(b)'s
                                         # checkpoint, (a)'s first update
WAVEFRONT_KINDS = ("GEQRT", "LARFB", "TSQRT", "SSRFB", "QLARFB", "QSSRFB")


def mesh_setup():
    """Phase 14's model, weights and batches, with ``qr_shard_leaves``:
    each leaf's stack one planned dispatch (on a mesh, each rank's slice
    of it)."""
    from repro_torch.training import TrainConfig

    cfg, data, run, _ = train_setup(None)
    return cfg, data, run, TrainConfig(optimizer="muon-qr",
                                       qr_shard_leaves=True)


def whole_params(trainer):
    """Every parameter, whole (a collective on a mesh), cloned."""
    from repro_torch.distributed import sharding

    return {k: (sharding.full_tensor(p.detach()) if hasattr(p, "device_mesh")
                else p.detach()).clone()
            for k, p in trainer.state.params.named_parameters()}


def state_shas(torch, trainer):
    """The sha256 of every leaf of what a checkpoint holds, whole."""
    from repro_torch.checkpoint.manager import _leaves_with_path
    from repro_torch.distributed import sharding

    out = {}
    for k, x in _leaves_with_path(trainer.checkpoint_tree()):
        if hasattr(x, "device_mesh"):
            x = sharding.full_tensor(x.detach())
        out[k] = sha(torch, x) if isinstance(x, torch.Tensor) else repr(x)
    return out


def check_mesh_launches(launches):
    """One step's launches of the leaf-by-leaf stacks: the 1536 x 576
    class's 90 slices on the wavefront rung as in phase 14, one batched
    megakernel launch and one over its Q table for each (30, 576, 576)
    stack, the panel kernels for the (30, 576, 192) stacks."""
    for k in WAVEFRONT_KINDS:
        assert launches.get(k) == ORTHO_LAUNCHES[k], (k, launches)
    assert launches.get("MEGAKERNEL_BATCHED") == 2, launches
    assert launches.get("MEGAKERNEL_Q_BATCHED") == 2, launches
    assert all(launches.get(k, 0) > 0 for k in
               ("MHT_PANEL", "WY_TRAILING", "WY_TRAILING_Q")), launches


def muon_keys(params):
    from repro_torch.optim import is_muon_param

    return [k for k, p in params.items() if is_muon_param(k, p)]


def mesh_single(torch, macro_ops, mesh, first_path):
    """17(a): phase 14's run with ``qr_shard_leaves`` on a (1, 1) mesh
    and without one, from the same weights and batches: one warm-up and
    three timed steps each; every O of the mesh run's warm-up step
    through phase 14's gates; losses, the first update against a TF32
    control, step ms and tokens/s, the step's launches.  The Muon leaves
    at the start and after the mesh-free run's first update go to
    ``first_path`` (host copies) for 17(b)."""
    from repro_torch.distributed import sharding
    from repro_torch.optim import muon_directions
    from repro_torch.optim.qr_muon import _orthogonalize_leaf
    from repro_torch.training import Trainer

    cfg, data, run, tcfg = mesh_setup()
    free = Trainer(cfg, tcfg, run, data, device="cuda", log_fn=log)
    start_tree = copy.deepcopy(free.state.params)
    start = whole_params(free)
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    free_ms = train_steps(torch, free, 1)
    free_launches = launch_counts(macro_ops)
    free_ms += train_steps(torch, free, 1)
    free_first = whole_params(free)
    free_ms += train_steps(torch, free, TRAIN_TIMED - 1)
    free_losses = [m["loss"] for m in free.metrics_history]
    del free
    torch.cuda.empty_cache()
    muon = muon_keys(start)
    torch.save({"start": {k: start[k].cpu() for k in muon},
                "first": {k: free_first[k].cpu() for k in muon}}, first_path)

    rules = sharding.MeshRules(mesh)
    trainer = Trainer(cfg, tcfg, run, data, device="cuda", mesh=mesh,
                      rules=rules, log_fn=log,
                      params=copy.deepcopy(start_tree))
    placed = all(hasattr(p, "device_mesh")
                 for p in trainer.state.params.parameters())
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    step_ms, record = recorded_step(torch, trainer)
    warm = launch_counts(macro_ops)
    # The warm-up step's momenta through the mesh route, whole.
    _, dirs = muon_directions(record["grads"], record["state"],
                              record["params"],
                              momentum=record["kw"]["momentum"])
    outs = [sharding.full_tensor(_orthogonalize_leaf(
        d, "qr", None, shard_leaves=True, rules=rules))
        for d in dirs.values()]
    leaves = [sharding.full_tensor(d) for d in dirs.values()]
    _, plain, ctrl = ortho_runs(torch, leaves)
    momenta = class_measures(torch, leaves, outs, plain, ctrl)
    del record, dirs, outs, leaves, plain, ctrl
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    step_ms += train_steps(torch, trainer, 1)
    step_launches = launch_counts(macro_ops)
    first = whole_params(trainer)
    step_ms += train_steps(torch, trainer, TRAIN_TIMED - 1)
    losses = [m["loss"] for m in trainer.metrics_history]
    del trainer
    torch.cuda.empty_cache()

    ctrl_run = Trainer(cfg, tcfg, run, data, device="cuda", mesh=mesh,
                       rules=rules, log_fn=log,
                       params=copy.deepcopy(start_tree))
    with wrapped_update(tf32_update(torch)):
        ctrl_run.run(stop_at=2)
    ctrl_first = whole_params(ctrl_run)
    del ctrl_run, start_tree
    torch.cuda.empty_cache()
    timed, free_timed = (statistics.median(step_ms[1:]),
                         statistics.median(free_ms[1:]))
    out = dict(
        placed=placed, losses=losses, mesh_free_losses=free_losses,
        rel_diff=[abs(a - b) / abs(b) for a, b in zip(losses, free_losses)],
        first_update=relative_change(torch, first, free_first, start, muon),
        tf32_control_first_update=relative_change(torch, ctrl_first,
                                                  free_first, start, muon),
        step_ms=step_ms, mesh_free_step_ms=free_ms, step_ms_median=timed,
        mesh_free_step_ms_median=free_timed,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (timed / 1e3),
        mesh_free_tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / (free_timed / 1e3),
        step_over_mesh_free=timed / free_timed, warmup_launches=warm,
        mesh_free_warmup_launches=free_launches, launches=step_launches,
        momenta=momenta)
    del start, first, free_first, ctrl_first
    torch.cuda.empty_cache()
    log("mesh (1, 1):", json.dumps(out))
    assert placed, out
    assert all(math.isfinite(x) for x in losses + free_losses), out
    assert len(losses) == len(free_losses) == 1 + TRAIN_TIMED, out
    assert max(out["rel_diff"]) <= MESH_LOSS_RTOL, out
    assert out["first_update"] <= MESH_UPDATE_RTOL, out
    assert out["tf32_control_first_update"] > MESH_UPDATE_RTOL, (
        "the TF32 control passed", out)
    check_classes(momenta)
    assert warm == free_launches == step_launches, out
    check_mesh_launches(step_launches)
    return out


def mesh_update_checks(torch, record, rules, lr):
    """17(b)'s optimizer on this rank, from one step's recorded inputs
    (``recorded_step``) at the learning rate ``lr``: the rank's
    layer-shard of every O that the mesh route returns and of its
    momentum (the 15-slice stacks this rank factors), through phase 14's
    gates against the plain lowering and its TF32 control on the same
    slices (:func:`class_measures`); and the Muon leaves' update by the
    mesh route against the mesh-free update of the same inputs, whole
    (``||P_mesh - P_free|| / ||P_free - P_start||``), beside the mesh
    route with TF32 products."""
    from repro_torch.distributed import sharding
    from repro_torch.optim import MuonState, muon_directions, muon_update
    from repro_torch.optim.qr_muon import _orthogonalize_leaf, _shard_spec

    grads, state, params = record["grads"], record["state"], record["params"]
    kw = dict(record["kw"], lr=lr)
    _, dirs = muon_directions(grads, state, params, momentum=kw["momentum"])
    moms, outs = [], []
    for d in dirs.values():
        o = _orthogonalize_leaf(d, "qr", None, shard_leaves=True, rules=rules)
        spec = _shard_spec(tuple(d.shape), rules)
        places = sharding.placements(
            sharding.Spec(*spec[:-2], None, None), d.device_mesh)
        moms.append(sharding.redistribute(d, places).to_local())
        outs.append(sharding.redistribute(o, places).to_local())
    leads = {k: int(m.shape[0]) for k, m in zip(dirs, moms)}
    _, plain, ctrl = ortho_runs(torch, moms)
    momenta = class_measures(torch, moms, outs, plain, ctrl)
    del dirs, moms, outs, plain, ctrl

    muon = muon_keys(params)

    def whole(tree):
        return {k: sharding.full_tensor(tree[k]) for k in tree}

    new = whole(muon_update(grads, state, params, **kw)[0])
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = whole(muon_update(grads, state, params, **kw)[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    start = whole(params)
    free = muon_update(whole(grads), MuonState(
        step=state.step, mu=whole(state.mu), nu=whole(state.nu)),
        start, **kw)[0]
    out = dict(local_leads=leads, momenta=momenta,
               update=relative_change(torch, new, free, start, muon),
               tf32_control_update=relative_change(torch, tf32, free, start,
                                                   muon))
    del new, tf32, start, free
    torch.cuda.empty_cache()
    return out


def rank_mesh(torch, dist, rank, world):
    """17(b)-(d) on one of ``world`` ranks sharing the card: phase 14's
    run with ``qr_shard_leaves`` on a (world, 1) mesh (data-parallel,
    parameters and state sharded over "data"): a warm-up step (its
    inputs recorded), step 2 (timed, its launches, the Muon leaves after
    it against (a)'s mesh-free run), the optimizer's checks
    (:func:`mesh_update_checks`, on the warm-up's inputs at step 2's
    rate), step 3 traced (each class's ms, the step's parts and their
    redistributions) and then saved, the whole state's sha256, step 4
    without a break (timed); then C10's divergent copies, and the
    fingerprint's cost at 4096^2."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.distgraph import sharded_tiled_qr
    from repro_torch.distributed import sharding
    from repro_torch.kernels import macro_ops
    from repro_torch.observability import instrument, trace
    from repro_torch.training import Trainer

    cfg, data, run, tcfg = mesh_setup()
    mesh = init_device_mesh("cuda", (world, 1),
                            mesh_dim_names=("data", "model"))
    rules = sharding.MeshRules(mesh)
    tr = Trainer(cfg, tcfg, run, data, device="cuda", mesh=mesh, rules=rules,
                 log_fn=log if rank == 0 else (lambda _: None))
    local = {k: list(p.to_local().shape)
             for k, p in tr.state.params.named_parameters()}
    step_ms, record = recorded_step(torch, tr)
    torch.cuda.synchronize()
    macro_ops.reset_launch_counts()
    step_ms += train_steps(torch, tr, 1)
    launches = launch_counts(macro_ops)
    single = torch.load(os.path.join(os.environ[MESH_DIR_ENV], "first.pt"))
    after = whole_params(tr)
    muon = list(single["start"])
    first_vs_single = relative_change(
        torch, after, {k: v.cuda() for k, v in single["first"].items()},
        {k: v.cuda() for k, v in single["start"].items()}, muon)
    del single, after
    torch.cuda.empty_cache()
    checks = mesh_update_checks(torch, record, rules, tcfg.lr)
    del record
    torch.cuda.empty_cache()
    trace.clear()
    with instrument.enabled_scope(tracing=True, annotations=False):
        tr.run(stop_at=3)
    spans = trace.spans()
    trace.clear()
    by_sid = {sp.sid: sp for sp in spans}

    def part(sp):
        """The step part (top-level span) ``sp`` ran in."""
        while sp.parent_sid in by_sid:
            sp = by_sid[sp.parent_sid]
        return sp.name

    class_ms, parts = {}, {}
    for sp in spans:
        ms = sp.duration_us / 1e3
        if sp.name == "optim.ortho_class":
            b = sp.labels["bucket"]
            class_ms[b] = class_ms.get(b, 0.0) + ms
        elif sp.name in ("train.fwd_bwd", "train.optimizer"):
            parts[sp.name] = parts.get(sp.name, 0.0) + ms
        elif sp.name == "distributed.collective" and \
                sp.labels.get("op") == "redistribute":
            key = "redistribute in " + part(sp)
            parts[key] = parts.get(key, 0.0) + ms
    tr.ckpt = CheckpointManager(os.path.join(os.environ[MESH_DIR_ENV],
                                             "ckpt"))
    tr._save(blocking=True)
    tr.ckpt.wait_until_finished()
    shas = state_shas(torch, tr)
    tr.ckpt = None
    step_ms += train_steps(torch, tr, 1)        # step 4; step 3 was traced
    losses = [m["loss"] for m in tr.metrics_history]
    del tr
    torch.cuda.empty_cache()

    mine = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        (256, 128))).cuda()
    try:
        sharded_tiled_qr(mine, tile=32)
        raised = ""
    except ValueError as e:
        raised = type(e).__name__
    a = torch.from_numpy(np.random.default_rng(DIST_N).standard_normal(
        (DIST_N, DIST_N)).astype(np.float32)).cuda()
    fp_ms, fp_all = barrier_ms(torch, dist,
                               lambda: sharding.check_same_copies(a, None))
    return dict(losses=losses, launches=launches, step_ms=step_ms,
                step_ms_median=statistics.median(step_ms[1:]),
                class_ms_step3=class_ms, span_ms_step3=parts, shas=shas,
                local_shapes=local, first_update_vs_single=first_vs_single,
                **checks,
                c10=raised, fingerprint_ms=fp_ms, fingerprint_ms_all=fp_all)


RANK_JOBS["mesh"] = rank_mesh


def elastic_restore(torch, ckdir, ranks):
    """17(c): ``plan_elastic_mesh`` over the two ranks with rank 1
    failed gives a (1, 1) mesh; a trainer on it restores 17(b)'s step 3
    (each leaf's sha256 equal to the saved one, whole) and runs step 4,
    whose loss is held to the uninterrupted run's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import plan_elastic_mesh
    from repro_torch.training import Trainer

    cfg, data, run, tcfg = mesh_setup()
    plan = plan_elastic_mesh(list(range(MESH_RANKS)), failed=[1],
                             prefer_model=1)
    tr = Trainer(cfg, tcfg, run, data, device="cuda",
                 mesh=plan.device_mesh("cuda"), log_fn=log)
    tr.ckpt = CheckpointManager(ckdir)
    t0 = time.perf_counter()
    restored = tr.maybe_restore()
    restore_s = time.perf_counter() - t0
    step = tr.step_idx
    shas = state_shas(torch, tr)
    tr.ckpt = None
    tr.run(resume=False, stop_at=4)
    loss = tr.metrics_history[-1]["loss"]
    del tr
    torch.cuda.empty_cache()
    want = ranks[0]["losses"][3]
    out = dict(plan=[plan.data_size, plan.model_size, plan.dropped_devices],
               restored=restored, step=step, restore_s=restore_s,
               leaves=len(shas),
               unequal_leaves=[k for k in shas if shas[k] != ranks[0]["shas"][k]],
               step4_loss=loss, uninterrupted_step4_loss=want,
               rel_diff=abs(loss - want) / abs(want))
    log("mesh elastic:", json.dumps(out))
    assert plan.size == 1 and restored and step == 3, out
    assert set(shas) == set(ranks[0]["shas"]) and not out["unequal_leaves"], out
    assert out["rel_diff"] <= MESH_LOSS_RTOL, out
    return out


def phase_mesh(torch, macro_ops):
    """Phase 17: mesh training on the card (a) on a (1, 1) mesh in this
    process (a one-rank gloo group), (b) on two gloo ranks sharing the
    card (their DTensor collectives staged through host memory), (c) the
    elastic restore of (b)'s checkpoint on a (1, 1) mesh, (d) C10 on the
    two ranks.  Returns the results and the launches: (a)'s step and
    each rank's step 2."""
    import datetime
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        tmp, "store"), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        single = mesh_single(torch, macro_ops, mesh,
                             os.path.join(tmp, "first.pt"))
        os.environ[MESH_DIR_ENV] = tmp
        ranks = [o["mesh"] for o in spawn_ranks(MESH_RANKS, ["mesh"])]
        cfg = mesh_setup()[0]
        for i, r in enumerate(ranks):
            assert r["losses"] == ranks[0]["losses"], (i, r["losses"])
            rel = [abs(x - y) / abs(y)
                   for x, y in zip(r["losses"], single["losses"])]
            assert len(rel) == 1 + TRAIN_TIMED and max(rel) <= \
                MESH_LOSS_RTOL, (i, r["losses"], single["losses"])
            for k, v in single["launches"].items():
                half = v // MESH_RANKS if k in WAVEFRONT_KINDS else v
                assert r["launches"].get(k) == half, (i, k, r["launches"])
            assert set(r["launches"]) == set(single["launches"]), r
            assert r["c10"] == "DivergentCopiesError", (i, r["c10"])
            # Each rank factors its 15 of every stack's 30 slices.
            assert set(r["local_leads"].values()) == {
                cfg.n_periods // MESH_RANKS}, (i, r["local_leads"])
            check_classes(r["momenta"])
            assert r["update"] <= MESH_UPDATE_RTOL, (i, r["update"])
            assert r["tf32_control_update"] > MESH_UPDATE_RTOL, (
                "the TF32 control passed", i, r["tf32_control_update"])
        # FSDP on "data": the down projection's (d_ff, d) slices split d.
        assert ranks[0]["local_shapes"]["layers.0.ffn.down.w"] == [
            cfg.n_periods, cfg.d_ff, cfg.d_model // MESH_RANKS], \
            ranks[0]["local_shapes"]
        elastic = elastic_restore(torch, os.path.join(tmp, "ckpt"), ranks)
    finally:
        os.environ.pop(MESH_DIR_ENV, None)
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    summary = dict(
        single=single,
        ranks=[{k: v for k, v in r.items() if k not in ("shas",
                                                        "local_shapes")}
               for r in ranks],
        elastic=elastic)
    log("mesh:", json.dumps(summary))
    return summary, dict(a=single["launches"],
                         b=[r["launches"] for r in ranks])



# Phase 18: LM serving.  Batch, prompt and new tokens of (a) and (b).
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 256, 32
# (c): prompt and decode steps.  The gate on the largest logit gap,
# relative to the largest |logit|: CONSIST_NOISE x the model's own fp32
# rounding noise (``forward_train`` of the same tokens at batch 1 against
# batch 3), at least CONSIST_FLOOR; that noise itself at most NOISE_MAX.
# A bf16 rounding of the carried state moves the logits by ~1e-3.
CONSIST_PREFILL, CONSIST_DECODE = 48, 16
CONSIST_NOISE, CONSIST_FLOOR, NOISE_MAX = 4.0, 1e-5, 1e-3
JAMBA_CUT = ("n_layers 32 -> 8: one period (7 mamba, 1 attention, 4 MoE, "
             "4 dense); the whole model is 208 GB in fp32, one card has 80")
HBM_BYTES_PER_S = 3.35e12


def serve_configs(smoke=False):
    """(label, config, cut) of phase 18's three models."""
    from repro_torch.configs import get_config, get_smoke_config

    get = get_smoke_config if smoke else get_config
    jamba = get("jamba-v0.1-52b")
    return [("xlstm-1.3b", get("xlstm-1.3b"), None),
            ("smollm-135m", get("smollm-135m"), None),
            ("jamba-v0.1-52b", jamba.scaled(n_layers=len(jamba.period)),
             JAMBA_CUT)]


def decode_bytes(cfg, n_params, batch, max_len):
    """Bytes one decode step moves, (cast model, floor): every weight
    the step uses read in fp32 and, as ``dense`` casts it, written and
    read again in bf16 (8 B a parameter; 4 B for the floor, each weight
    read once), plus the recurrent states read and written and the K/V
    caches read.  An untied embedding table is only gathered."""
    used = n_params - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model)
    per = cfg.n_periods
    state = 0
    for spec in cfg.period:
        if spec.mixer == "mlstm":
            di = int(cfg.mlstm_proj_factor * cfg.d_model)
            state += per * 2 * batch * di * (di // cfg.n_heads) * 4
        elif spec.mixer == "mamba":
            di = cfg.d_inner or 2 * cfg.d_model
            state += per * 2 * batch * di * cfg.d_state * 4
        elif spec.mixer == "slstm":
            state += per * 2 * batch * 4 * cfg.d_model * 4
        else:
            state += per * 2 * batch * max_len * cfg.d_kv * 2
    return 8 * used + state, 4 * used + state


def serve_consistency(torch, params, cfg, dev, control=False):
    """``(gap, noise)``: the largest gap between prefill (48 tokens) + 16
    decode steps and ``forward_train`` over all 64 tokens, at each
    step's position, and the largest gap at those positions between
    ``forward_train`` of the same tokens at batch 1 and at batch 3 (the
    model's own fp32 rounding noise: other GEMM shapes, the same
    function), each relative to the largest |logit|.  fp32
    (``cfg.scaled(dtype="float32")``), MoE capacity 8.0.  ``control``
    rounds every carried cache and state to bf16 between prefill and
    decode."""
    from repro_torch.models import (forward_decode, forward_prefill,
                                    forward_train)

    cfg = cfg.scaled(dtype="float32")
    if cfg.moe is not None:
        cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    s0, s = CONSIST_PREFILL, CONSIST_PREFILL + CONSIST_DECODE
    toks = torch.randint(0, cfg.vocab_size, (1, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    with torch.inference_mode():
        full, _ = forward_train(params, {"tokens": toks}, cfg)
        plog, caches = forward_prefill(params, {"tokens": toks[:, :s0]}, cfg)
        if control:
            caches = tuple({k: v.to(torch.bfloat16).to(v.dtype)
                            for k, v in e.items()} for e in caches)
        caches = tuple({k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, s - s0))
                        for k, v in e.items()} if "k" in e else e
                       for e in caches)
        gaps = [(plog[:, 0] - full[:, s0 - 1]).abs().max()]
        for t in range(s0, s):
            dlog, caches = forward_decode(params, toks[:, t:t + 1], cfg,
                                          caches, t)
            gaps.append((dlog[:, 0] - full[:, t]).abs().max())
        scale = full[:, s0 - 1:].abs().max()
        three, _ = forward_train(params, {"tokens": toks.repeat(3, 1)}, cfg)
        noise = (three[1:2, s0 - 1:] - full[:, s0 - 1:]).abs().max()
        return (float(torch.stack(gaps).max() / scale),
                float(noise / scale))


def serve_model(torch, label, cfg, dev, independent):
    """Phase 18(b) and (c) on one model: weights drawn on the device from
    a generator seeded with 0; two greedy ``generate`` calls (the first
    warms up, the second is timed for tokens/s and peak memory), then
    prefill and each decode step timed alone; request 0's tokens with
    request 2's prompt changed (``independent``); (c)'s consistency and
    its bf16 control on the same weights."""
    from repro_torch.models import init_params, param_count
    from repro_torch.serving import ServeEngine

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    sync()
    out = dict(params=param_count(params), init_s=time.perf_counter() - t0)
    max_len = SERVE_PROMPT + SERVE_STEPS + 8
    engine = ServeEngine(params, cfg, batch=SERVE_BATCH, max_len=max_len,
                         device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1))
    t0 = time.perf_counter()
    first = engine.generate(prompts, SERVE_STEPS)
    sync()
    out["first_generate_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(prompts, SERVE_STEPS)
    sync()
    wall = time.perf_counter() - t0
    out["generate_s"] = wall
    out["tokens_per_s"] = SERVE_BATCH * SERVE_STEPS / wall
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    assert tuple(first.shape) == (SERVE_BATCH, SERVE_STEPS), first.shape
    assert int(first.min()) >= 0 and int(first.max()) < cfg.vocab_size
    assert torch.equal(first, again), (label, "greedy runs differ")

    sync()
    t0 = time.perf_counter()
    logits, caches = engine.prefill(prompts)
    sync()
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    tok = engine.sample(logits)
    toks, step_ms = [tok], []
    for i in range(SERVE_STEPS - 1):
        t0 = time.perf_counter()
        logits, caches = engine.decode(tok, caches, SERVE_PROMPT + i)
        tok = engine.sample(logits)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        toks.append(tok)
    assert torch.equal(torch.cat(toks, dim=1), first), (label, "stepped run")
    out["decode_ms_median"] = statistics.median(step_ms)
    out["decode_ms_min"] = min(step_ms)
    if cuda:
        trace = profile_window(torch, lambda: engine.decode(
            tok, caches, SERVE_PROMPT + SERVE_STEPS - 1))
        out["decode_trace"] = {k: trace.get(k) for k in (
            "device_ops", "busy_ms", "wall_ms_profiled", "busy_share_of_wall")}
    model_b, floor_b = decode_bytes(cfg, out["params"], SERVE_BATCH, max_len)
    out["decode_bytes_cast_model"] = model_b
    out["decode_bound_ms_cast_model"] = model_b / HBM_BYTES_PER_S * 1e3
    out["decode_bound_ms_fp32_floor"] = floor_b / HBM_BYTES_PER_S * 1e3
    del caches, logits
    if independent:
        other = prompts.clone()
        other[2] = (other[2] + 1) % cfg.vocab_size
        changed = engine.generate(other, SERVE_STEPS)
        assert torch.equal(changed[0], first[0]), (label, "request 0 moved")
        out["independence"] = "request 0 unchanged"
    else:
        out["independence"] = ("not checked: MoE capacity couples the "
                               "requests of one prefill batch, as in the "
                               "reference")
    out["consistency_rel"], out["fp32_noise_rel"] = serve_consistency(
        torch, params, cfg, dev)
    out["bf16_control_rel"], _ = serve_consistency(torch, params, cfg, dev,
                                                   control=True)
    out["consistency_tol"] = max(CONSIST_FLOOR,
                                 CONSIST_NOISE * out["fp32_noise_rel"])
    out["sample"] = first[0, :8].tolist()
    return out


def phase_lm_serving(torch, device="cuda", smoke=False):
    """Phase 18: (a) ``python -m repro_torch.launch.serve`` on xlstm-1.3b,
    whole (run in this process through its ``main``); (b) and (c) on
    xlstm-1.3b and smollm-135m, whole, and jamba-v0.1-52b cut to one
    period (:func:`serve_model`).  ``smoke``: the reduced configs, for a
    rehearsal on the CPU."""
    import gc
    import io

    from repro_torch.launch import serve

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    argv = ["--arch", "xlstm-1.3b", "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--steps", str(SERVE_STEPS),
            "--device", str(dev)] + (["--smoke"] if smoke else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        row = serve.main(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == row, line
    assert row["steps"] == SERVE_STEPS and len(row["sample"]) == min(
        16, SERVE_STEPS), row
    log("lm serving (a): python -m repro_torch.launch.serve", " ".join(argv))
    log(line)
    summary = {"launcher": row, "models": {}}
    for label, cfg, cut in serve_configs(smoke):
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = serve_model(torch, label, cfg, dev,
                          independent=cfg.moe is None)
        res["seconds"] = time.perf_counter() - t0
        res["reduced"] = cut
        summary["models"][label] = res
        log(f"lm serving {label}:", json.dumps(res))
        assert res["fp32_noise_rel"] <= NOISE_MAX, (label, res)
        assert res["consistency_rel"] <= res["consistency_tol"], (label, res)
        assert res["bf16_control_rel"] > res["consistency_tol"], (
            "the bf16 control passed", label, res)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return summary


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
    from repro_torch.core import blocked
    from repro_torch.kernels import _build, macro_ops, ops, tile_ops

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
    log(f"phase build: {time.perf_counter() - t0:.2f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    rows, _ = phase("kernel checks", phase_kernels, torch, engine, macro_ops)
    q_rows = phase("Q kernel checks", phase_q_kernels, torch, engine,
                   macro_ops)
    launches, e2e, lib = phase("main path 2048", phase_main_path, torch,
                               engine, macro_ops, repro_torch, N, "wavefront",
                               "main path")
    a = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (N, N)).astype(np.float32)).cuda()
    breakdown_2048 = phase("breakdown 2048", phase_breakdown, torch, engine,
                           macro_ops, tilegraph, a)
    phase("megakernel checks", phase_megakernel_checks, torch, engine,
          macro_ops, tilegraph)
    mega_launches, mega_ms, mega_lib = phase(
        "megakernel path 640", phase_main_path, torch, engine, macro_ops,
        repro_torch, N_MEGA, "megakernel", "megakernel path")
    stack_launches, stack_timing = phase(
        "batched path", phase_batched_path, torch, engine, macro_ops,
        repro_torch, tilegraph)
    mega_rows = phase("megakernel timing", phase_megakernel_timing, torch,
                      engine, macro_ops, tilegraph)
    bodies = phase("task bodies", phase_task_bodies, torch, engine, macro_ops)
    panel_rows, tile_launches = phase(
        "panel kernel checks", phase_panel_kernels, torch, macro_ops, ops,
        tile_ops, blocked)
    paths = phase("panel paths", phase_panel_paths, torch, macro_ops,
                  repro_torch)
    breakdown = phase("panel breakdown", phase_panel_breakdown, torch,
                      repro_torch, blocked)
    service, service_launches = phase("service", phase_service, torch,
                                      macro_ops, tilegraph, repro_torch)
    training, training_launches = phase("training", phase_training, torch,
                                        macro_ops)
    tuning, tuning_launches = phase(
        "tuning", phase_tuning, torch, macro_ops, repro_torch,
        mega_rows["MEGAKERNEL"], breakdown_2048["spun_device_span_ms"])
    distributed, distributed_launches = phase(
        "distributed", phase_distributed, torch, macro_ops, repro_torch)
    mesh, mesh_launches = phase("mesh", phase_mesh, torch, macro_ops)
    macro_ops.reset_launch_counts()
    lm = phase("lm serving", phase_lm_serving, torch)
    lm_launches = launch_counts(macro_ops)
    assert not lm_launches, ("the LM serving path runs none of the QR "
                             "kernels", lm_launches)

    def mesh_of(*kinds):
        """Phase 17's launches of ``kinds`` (summed): (a)'s timed step on
        the (1, 1) mesh, and each rank's step 2 in (b)."""
        return {"a": sum(mesh_launches["a"].get(k, 0) for k in kinds),
                "b": [sum(r.get(k, 0) for k in kinds)
                      for r in mesh_launches["b"]]}

    def dist_launches(*kinds):
        """Phase 16's launches of ``kinds`` (summed): per rank for each
        sharded cell, and the restart run's."""
        return {label: ([sum(r.get(k, 0) for k in kinds) for r in per_rank]
                        if isinstance(per_rank, list) else
                        sum(per_rank.get(k, 0) for k in kinds))
                for label, per_rank in distributed_launches.items()}
    # Each panel-path kernel's device time summed over one call of each
    # traced path (the profiler's spans), beside launches x one launch.
    summed = {}
    for key, kind in (("mht_panel", "MHT_PANEL"), ("wy_trailing", "WY_TRAILING")):
        summed[kind] = {
            label: sum(w.get("device_ms", {}).get(key, 0.0)
                       for w in parts.values() if isinstance(w, dict))
            for label, parts in breakdown.items()}

    kernels = []
    for kind in ("GEQRT", "LARFB", "TSQRT", "SSRFB", "QLARFB", "QSSRFB"):
        r = rows[kind] if kind in rows else q_rows[kind]
        kernel = (f"{kind.lower()}_kernel" if kind in ("GEQRT", "TSQRT")
                  else f"walk_kernel ({kind})")
        kernels.append(dict(
            name=kernel, route="cuda", source=SOURCE,
            replaces=REPLACES[kind], launches=launches[kind],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], ntasks=r["ntasks"],
            service_launches=service_launches.get(kind, 0),
            training_launches=training_launches.get(kind, 0),
            tuning_launches=tuning_launches.get(kind, 0),
            distributed_launches=dist_launches(kind),
            mesh_launches=mesh_of(kind),
            lm_serving_launches=lm_launches.get(kind, 0),
            **({"fp64_ms": r["fp64_ms"]} if "fp64_ms" in r else {}),
            **({"computes": Q_FORMATION} if kind.startswith("Q") else {})))
    for name, path_launches in (("MEGAKERNEL", mega_launches),
                                ("MEGAKERNEL_BATCHED", stack_launches),
                                ("MEGAKERNEL_Q", mega_launches),
                                ("MEGAKERNEL_Q_BATCHED", stack_launches)):
        r = mega_rows[name]
        kernels.append(dict(
            name=(name.replace("_Q", "").lower() + "_kernel"
                  + (" (Q table)" if "_Q" in name else "")),
            route="cuda", source=SOURCE,
            replaces=REPLACES[name], launches=path_launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"],
            service_launches=service_launches.get(name, 0),
            training_launches=training_launches.get(name, 0),
            tuning_launches=tuning_launches.get(name, 0),
            distributed_launches=dist_launches(name),
            mesh_launches=mesh_of(name),
            lm_serving_launches=lm_launches.get(name, 0),
            **({"computes": Q_FORMATION} if "_Q" in name else {})))
    path_launches = {
        "MHT_PANEL": {k: p["launches"].get("MHT_PANEL", 0)
                      for k, p in paths.items()},
        "WY_TRAILING": {k: p["launches"].get("WY_TRAILING", 0)
                        + p["launches"].get("WY_TRAILING_Q", 0)
                        for k, p in paths.items()},
    }
    for kind in ("MHT_PANEL", "WY_TRAILING", "TSQRT_TILE", "SSRFB_TILE"):
        r = panel_rows[kind]
        launched = (path_launches[kind]["4096"] if kind in path_launches
                    else tile_launches[kind])
        kernels.append(dict(
            name=f"{kind.lower()}_kernel", route="cuda", source=SOURCES[kind],
            replaces=REPLACES[kind], launches=launched,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            service_launches=service_launches.get(kind, 0),
            training_launches=(training_launches.get(kind, 0)
                               + training_launches.get(kind + "_Q", 0)),
            tuning_launches=tuning_launches.get(kind, 0),
            distributed_launches=dist_launches(kind, kind + "_Q"),
            mesh_launches=mesh_of(kind, kind + "_Q"),
            lm_serving_launches=lm_launches.get(kind, 0),
            **({"launches_by_path": path_launches[kind],
                "summed_device_ms_by_path": summed[kind]}
               if kind in path_launches else {})))
    log("card:", card, "| main path qr_ms", e2e, "| torch.linalg.qr ms", lib,
        "| 640 qr_ms", mega_ms, "| torch.linalg.qr ms", mega_lib,
        "| stack qr_ms", stack_timing["qr_ms"], "| torch.linalg.qr ms",
        stack_timing["torch_linalg_qr_ms"])
    forms = {"2048": breakdown_2048["form_q"],
             "640": breakdown_2048["form_q_640"],
             "stack": stack_timing["form_q"]}
    log("card:", card, "| Q formation host ms / device ms / launches:",
        json.dumps({k: [v["host_ms"], v["device_ms"], v["launches"]]
                    for k, v in forms.items()}),
        "| plain Q loop host ms:",
        json.dumps({k: v["plain_host_ms"] for k, v in forms.items()}))
    log("card:", card, "| task bodies us:", json.dumps(bodies),
        "| 640 megakernel ms per level",
        mega_rows["MEGAKERNEL"]["ms_per_level"], "| mht_panel us per column:",
        json.dumps({k: v["us_per_column"] for k, v in
                    panel_rows["MHT_PANEL"]["timing_by_shape"].items()}))
    log("card:", card, "| summed device ms per call (profiler):",
        json.dumps(summed), "| launches x ms at 4096^2:", json.dumps({
            kind: path_launches[kind]["4096"] * panel_rows[kind]["ms"]
            for kind in summed}))
    log("card:", card, "| megakernel ms per level / CTAs per SM:",
        json.dumps({k: [r["ms_per_level"], r.get("ctas_per_sm")]
                    for k, r in mega_rows.items()}),
        "| wy_trailing ms by shape:", json.dumps({
            k: [v["ms"], v["grid"]["layout"], v["grid"]["cluster"]] for k, v in
            panel_rows["WY_TRAILING"]["timing_by_shape"].items()}))
    log("card:", card, "| panel paths qr_ms / torch.linalg.qr ms:",
        json.dumps({k: [p["qr_ms"], p["torch_linalg_qr_ms"]]
                    for k, p in paths.items()}))
    mix, smollm = service["mix"], service["smollm"]
    log("card:", card, "| service mix p50 / p99 wave ms",
        mix["timing"]["p50_ms"], mix["timing"]["p99_ms"], "| matrices/s",
        mix["timing"]["matrices_per_s"], "| one flush per request",
        mix["timing"]["per_request_flush_matrices_per_s"],
        "| torch.linalg.qr per request",
        mix["timing"]["torch_linalg_qr_matrices_per_s"], "| fill",
        mix["timing"]["bucket_fill_ratio"], "| plan hit rate",
        mix["timing"]["cache_hit_rate"])
    log("card:", card, "| service SmolLM momenta wave ms", smollm["wave_ms"],
        "| padding waste", json.dumps(smollm["padding_waste"]),
        "| qr verify ms:", json.dumps({
            k: [v["qr_ms"], v["verified_qr_ms"]]
            for k, v in service["verify"].items()}),
        "| disabled span share of a 2048^2 qr",
        service["capture"]["span_share_of_qr"])
    tt, tl = training["timing"], training["losses"]
    log("card:", card, "| training SmolLM-135M step ms (median of",
        TRAIN_TIMED, ")", tt["step_ms_median"], "| tokens/s",
        tt["tokens_per_s"], "| fwd+bwd ms", tt["instrumented"]["train.fwd_bwd"],
        "| optimizer ms", tt["instrumented"]["train.optimizer"],
        "| ortho ms per class", json.dumps(tt["instrumented"]["per_class"]),
        "| optimizer alone: batched", tt["batched_optimizer_ms"], "leafwise",
        tt["leafwise_optimizer_ms"], "| torch.linalg.qr over the stacks",
        tt["torch_linalg_qr_ms"], "| losses", json.dumps(tl["losses"]),
        "| plain-lowering run", json.dumps(tl["plain_losses"]))
    log("card:", card, "| tuning sweep s", tuning["sweep_seconds"],
        "| per class best / heuristic us:", json.dumps({
            k: [v["best"][0], v["best_us"], v["heuristic"], v["heuristic_us"]]
            for k, v in tuning["classes"].items()}),
        "| qr ms tuned / heuristic / torch.linalg.qr:", json.dumps({
            k: [v["tuned"], v["heuristic"], v["torch_linalg_qr"]]
            for k, v in tuning["routes"]["qr_ms"].items()}),
        "| DAG depth 2048 / 640:", tuning["dag"]["2048"]["depth"],
        tuning["dag"]["640"]["depth"])
    dc, rs, cp = (distributed["cells"], distributed["restart"],
                  distributed["compression"])
    log("card:", card, "| distributed qr ms per rank (ranks share the card):",
        json.dumps({k: dc[k]["qr_ms"] for k in ("4096_d2", "4096_d4",
                                                  "tsqr_d4")}),
        "| merge / collective share (rank 0):", json.dumps({
            k: [dc[k]["spans"][0]["merge_share"],
                dc[k]["spans"][0]["collective_share"]]
            for k in ("4096_d2", "4096_d4", "tsqr_d4")}),
        "| beside:", json.dumps(dc["beside"]),
        "| compressed_psum ms:", json.dumps([p["ms"] for p in dc["psum"]]),
        "| copies check ms at 4096^2 d=2:",
        json.dumps(dc["4096_d2"]["fingerprint_ms"]),
        "| checkpoint bytes / snapshot ms / write s:", rs["checkpoint_bytes"],
        rs["snapshot_ms"], rs["write_s"], "| restart loss diff",
        rs["loss_diff"], "max param diff", rs["max_param_diff"],
        "| codec ms a step:", json.dumps(cp["codec_ms"]))
    ms1, mr, me = mesh["single"], mesh["ranks"], mesh["elastic"]
    log("card:", card, "| mesh (1, 1) step ms", ms1["step_ms_median"],
        "tokens/s", ms1["tokens_per_s"], "| mesh-free step ms",
        ms1["mesh_free_step_ms_median"], "tokens/s",
        ms1["mesh_free_tokens_per_s"], "| ratio", ms1["step_over_mesh_free"],
        "| first update", ms1["first_update"], "| (2, 1) ranks step ms",
        json.dumps([r["step_ms_median"] for r in mr]),
        "| 1536x576 class ms a rank (step 3, traced):",
        json.dumps([r["class_ms_step3"].get("1536x576") for r in mr]),
        "| fwd+bwd / optimizer ms and their redistributions a rank (step 3):",
        json.dumps([r["span_ms_step3"] for r in mr]),
        "| fingerprint ms at 4096^2 d=2:",
        json.dumps([r["fingerprint_ms"] for r in mr]),
        "| elastic restore s", me["restore_s"], "step-4 loss diff",
        me["rel_diff"])
    log("card:", card, "| lm serving: launcher", json.dumps(lm["launcher"]),
        "| prefill ms / decode ms a token (median) / bound ms (cast model) / "
        "tokens/s / peak GB / parameters / consistency / its gate / bf16 "
        "control:",
        json.dumps({k: [m["prefill_ms"], m["decode_ms_median"],
                        m["decode_bound_ms_cast_model"], m["tokens_per_s"],
                        m["peak_gb"], m["params"], m["consistency_rel"],
                        m["consistency_tol"], m["bf16_control_rel"]]
                    for k, m in lm["models"].items()}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
