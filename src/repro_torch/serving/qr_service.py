"""QR-as-a-service: shape-bucketed batched factorization serving.

Counterpart of the reference's ``repro.serving.qr_service``.  The engine
factors one matrix per call; production traffic is many concurrent
heterogeneous ``(m, n, dtype, mode)`` requests.  The tiled DAG's tasks
are independent across matrices exactly as they are across tiles, so
throughput comes from keeping the card saturated with macro-op work:
:class:`QRService` buckets submissions by padded shape class
(:mod:`repro_torch.serving.bucketing`), zero-pads and stacks each bucket,
and factors it in ONE call of :func:`repro_torch.core.tilegraph.
_factor_stack_padded` — on the megakernel rung one launch of the batched
megakernel for the whole stack and one more over the Q table.

The pipeline per :meth:`QRService.flush`:

    requests -> admission -> bucketize -> (plan cache: BucketKey x batch
    x rung -> prepared plan) -> dispatch bucket i, then stage bucket
    i+1's pinned host buffer to the card on a side stream while bucket i
    computes -> wait + health check -> unpad + scatter results back

A request that is already a tensor on the service's device stays there:
admission scans it on the device, and its bucket's padded stack takes it
by a device-to-device copy; only host arrays go through the pinned
staging buffer.

**Prepared-plan cache.**  The port compiles no executables (its kernels
are built once per process); what a bucket's dispatch needs prepared is
kept in an LRU of :class:`_BucketPlan` keyed on ``(BucketKey,
padded_batch, rung)``: the rung, the tile grid, the
device-resident task tables, level indices and CTA runs (uploaded
through :func:`repro_torch.core.engine.prepare_dispatch`), and a pinned
host staging buffer (made on the first host array staged).  Building one
is the only site that counts ``compiles`` and the only site of the
``compile`` fault; it runs the engine's dispatch guards for its rung, so
a budget (``vmem``) rejection walks ``megakernel -> wavefront`` at plan
time, as the reference's does at compile time.  A steady-state stream (warmed cache) builds nothing and
uploads nothing but its requests.  A prepared plan bakes in the rung
the measured tuning cache chose (:meth:`QRService._initial_rung`), so
when the active cache changes (:func:`_tuning_fingerprint`) the service
drops every plan (``plan_invalidations``) and resets its open circuit
breakers (``breaker_resets``), as the reference does.

**Failure hardening** (:mod:`repro_torch.robustness`).  Three lines of
defense, each named and counted:

  * *Admission* — :meth:`submit` runs the finite/shape/dtype guard
    (``admission`` policy); a rejected payload is **quarantined** (its
    :class:`QRResult` carries ``error="quarantined:<reason>"``) instead
    of poisoning the padded bucket it would have shared.
  * *Verification* — with the ``verify`` knob on (``$REPRO_VERIFY``
    default), every bucket is health-checked **per slice** (residual +
    orthogonality against the conformance tolerance, on the card); only
    the failing slices re-solve, the healthy bucket-mates ship as-is.
  * *Escalation* — a failed plan build, dispatch, or health check walks
    the degradation ladder megakernel -> wavefront -> oracle -> lapack
    (:mod:`repro_torch.robustness.escalate`), recording
    ``robustness.escalations{from, to, reason}``.  A bucket that
    escalates ``breaker_threshold`` times trips its **circuit breaker**:
    its plans are evicted and the bucket pins to the lapack fallback.
    On the kernel rungs only injected faults walk the ladder, and a
    budget rejection moves megakernel -> wavefront at plan time (which
    does not count towards the breaker): a real launch error, a kernel's
    own output failing its health check, and a failed kernel-library
    build raise, and a breaker that would pin a kernel-path bucket after
    a real failure raises :class:`~repro_torch.robustness.escalate.
    KernelFault` instead.  A kernel's fault is never served by the plain
    lowering or by ``torch.linalg.qr``.

Flush is failure-atomic: if an exception does escape (escalation
disabled, or a non-recoverable error), every request that has not been
resolved into a result is restored to the pending queue before the
exception propagates — no request is silently dropped.  Flush returns
when the card has finished the work it returns.

Zero padding is numerically free (padded rows/cols factor to
exactly-zero reflectors), and a batched slice is bitwise the single run,
so serving answers are the answers the per-request path would have
produced.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.plan import (as_torch_dtype, resolve_device,
                                   tuned_dispatch_mode)
from repro_torch.core.tilegraph import _factor_stack_padded
from repro_torch.kernels import _build
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace
from repro_torch.robustness import escalate as _escalate
from repro_torch.robustness import guards as _guards
from repro_torch.robustness import inject as _inject
from repro_torch.robustness import verify as _verify
from repro_torch.tuning import cache as _tcache
from repro_torch.serving.bucketing import (
    BucketKey, BucketingPolicy, bucketize, pad_batch)

__all__ = ["QRRequest", "QRResult", "QRService"]

# Distinguishes each QRService instance's series in the process-global
# metrics registry, so a fresh service starts from zero counts.
_SERVICE_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class QRRequest:
    """One queued factorization: the payload (a host array, or a tensor on
    the service's device) plus its bucket identity."""

    rid: int
    a: Union[np.ndarray, torch.Tensor]
    mode: str
    t_submit: float = 0.0      # monotonic clock at submit (queue-wait base)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.a.shape)  # type: ignore[return-value]

    @property
    def dtype(self) -> np.dtype:
        if isinstance(self.a, torch.Tensor):
            return torch.empty(0, dtype=self.a.dtype).numpy().dtype
        return self.a.dtype


@dataclasses.dataclass(frozen=True)
class QRResult:
    """Unpadded per-request answer on the service's device; ``q`` is None
    for mode="r".

    ``error`` is None for a healthy result; a quarantined or
    unrecoverable request carries the named reason
    (``"quarantined:nonfinite_input"``, ``"escalation_exhausted"``,
    ...) and ``q``/``r`` may be None."""

    rid: int
    q: Optional[torch.Tensor]
    r: Optional[torch.Tensor]
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


def _tuning_fingerprint() -> Tuple:
    """Identity of the active measured tuning cache (source + contents
    summary).  Prepared bucket plans bake in its routing (the dispatch
    mode of a shape class), so a new cache — a sweep installed with
    ``set_active_cache`` or ``$REPRO_TORCH_TUNING_CACHE`` — invalidates
    them."""
    info = _tcache.active_cache_info()
    return (info["source"], info["entries"], tuple(info["classes"]))


@dataclasses.dataclass
class _BucketPlan:
    """One prepared bucket dispatch (the plan-cache value)."""

    key: BucketKey
    batch: int                 # padded batch the plan expects
    grid: Tuple[int, int]      # (p, q) tile grid
    nb: int
    dispatch_mode: Optional[str]
    rung: str                  # ladder rung this plan executes at
    dtype: torch.dtype
    # (batch, m, n) host buffer, pinned for a card; made when the first
    # host array is staged (a stream of device tensors never needs one).
    staging: Optional[torch.Tensor] = None
    copied: Optional[torch.cuda.Event] = None  # last copy out of staging


class QRService:
    """Batched QR serving: submit heterogeneous requests, get per-request
    factors back from shape-bucketed single-dispatch execution.

        service = QRService()                       # on "cuda"
        rid = service.submit(a, mode="reduced")     # queue
        out = service.flush()[rid]                  # bucket + dispatch
        results = service.submit_many(arrays)       # pipelined stream

    Parameters
    ----------
    policy:        bucketing policy (tile size, waste cap, max batch).
    use_kernel:    the engine's kernel lowering — None means the kernels
                   on "cuda" and the plain lowering on "cpu".
    dispatch_mode: engine kernel lowering per bucket; None lets the
                   engine's budget rule pick (megakernel when the task
                   table and working set fit).
    device:        where buckets are factored and results live; None
                   means "cuda" (raises without a card).
    cache_size:    max resident prepared bucket plans (LRU).
    admission:     input guard run at submit (None disables; default:
                   finite 2-D float — :mod:`repro_torch.robustness.guards`).
    verify:        post-dispatch per-slice health checks — True/False
                   force, None defers to ``$REPRO_VERIFY``.
    escalate:      walk the degradation ladder on failures (False keeps
                   the raise-through behavior; flush stays atomic).
    breaker_threshold: escalations a bucket tolerates before its
                   circuit breaker opens (plans evicted, bucket pinned
                   to the lapack fallback).
    """

    def __init__(self, *, policy: Optional[BucketingPolicy] = None,
                 use_kernel: Optional[bool] = None,
                 dispatch_mode: Optional[str] = None,
                 device=None,
                 cache_size: int = 32,
                 admission: Optional[_guards.AdmissionPolicy] =
                 _guards.DEFAULT_ADMISSION,
                 verify: Optional[bool] = None,
                 escalate: bool = True,
                 breaker_threshold: int = 3):
        if cache_size < 1:
            raise ValueError(f"cache_size must be >= 1, got {cache_size}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.policy = BucketingPolicy() if policy is None else policy
        self.use_kernel = (self.device.type == "cuda"
                           if use_kernel is None else bool(use_kernel))
        self.dispatch_mode = dispatch_mode
        self.cache_size = cache_size
        self.admission = admission
        self.verify = verify
        self.escalate = escalate
        self.breaker_threshold = breaker_threshold
        self._plans: "collections.OrderedDict[Tuple, _BucketPlan]" \
            = collections.OrderedDict()
        self._pending: List[QRRequest] = []
        self._quarantined: Dict[int, str] = {}    # rid -> named reason
        self._esc_counts: Dict[BucketKey, int] = {}
        self._real_esc: Set[BucketKey] = set()   # counted a real failure
        self._breaker_open: Set[BucketKey] = set()
        self.escalations: List[_escalate.Escalation] = []
        self._tuning_fp = _tuning_fingerprint()
        self._next_rid = 0
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        # Counters live in the process-global metrics registry under this
        # instance's ``service`` label; stats() is a view over them.
        self._sid = f"qr{next(_SERVICE_IDS)}"

    # ---------------------------------------------------- metrics plumbing

    def _count(self, name: str, amount: int = 1) -> None:
        _metrics.counter(f"serving.{name}", service=self._sid).inc(amount)

    def _count_value(self, name: str) -> int:
        return int(_metrics.counter_value(f"serving.{name}", service=self._sid))

    def _observe(self, name: str, value: float, **labels: object) -> None:
        _metrics.histogram(f"serving.{name}", service=self._sid,
                           **labels).observe(value)

    def _verify_on(self) -> bool:
        return _verify.verify_enabled(self.verify)

    # ------------------------------------------------------------ intake

    def submit(self, a, mode: str = "reduced") -> int:
        """Queue one matrix; returns the request id :meth:`flush` keys
        results on.  A tensor on the service's device is queued as it is,
        without a copy — do not write to it before the flush — and its
        bucket takes it by a device-to-device copy; anything else is held
        in host memory and staged to the device with its bucket.

        Admission runs here — a payload the guard rejects is
        quarantined (``flush()`` returns an error-carrying
        :class:`QRResult` for it) rather than stacked into a bucket
        where its NaNs would contaminate every bucket-mate."""
        if isinstance(a, torch.Tensor):
            arr = (a.detach() if a.device == self.device
                   else a.detach().cpu().numpy())
        else:
            arr = np.asarray(a)
        if arr.ndim != 2:
            raise ValueError(
                f"expected one matrix, got shape {tuple(arr.shape)}")
        if mode not in ("reduced", "r"):
            raise ValueError(
                f"serving modes are 'reduced' and 'r', got {mode!r}")
        rid = self._next_rid
        self._next_rid += 1
        self._count("requests")
        if _inject.enabled():
            arr = _inject.corrupt_input(
                arr, f"{arr.shape[0]}x{arr.shape[1]}")
        if self.admission is not None:
            try:
                _guards.admit(arr, policy=self.admission)
            except _guards.AdmissionError as e:
                self._quarantined[rid] = e.reason
                self._count("quarantined")
                _metrics.counter("robustness.quarantined",
                                 reason=e.reason).inc()
                return rid
        self._pending.append(QRRequest(rid=rid, a=arr, mode=mode,
                                       t_submit=time.monotonic()))
        return rid

    def submit_many(self, arrays: Sequence, mode: str = "reduced"
                    ) -> List[QRResult]:
        """Submit a homogeneous-mode stream and flush it; results come
        back in submission order.  Buckets are dispatched back-to-back
        with the NEXT bucket's host->device copy staged while the
        current one computes (see :meth:`flush`)."""
        rids = [self.submit(a, mode=mode) for a in arrays]
        results = self.flush()
        return [results[rid] for rid in rids]

    # --------------------------------------------------------- plan cache

    def _grid(self, key: BucketKey) -> Tuple[int, int, int]:
        nb = min(self.policy.tile, key.m, key.n)
        return -(-key.m // nb), -(-key.n // nb), nb

    def _check_tuning(self) -> None:
        """Tuning-cache refresh: every prepared plan may bake in a rung the
        new measurements contradict — drop them all (they rebuild lazily
        on next use).  An open circuit breaker also resets: the new
        measurements may route the bucket around whatever kept failing."""
        fp = _tuning_fingerprint()
        if fp == self._tuning_fp:
            return
        self._tuning_fp = fp
        if self._plans:
            self._count("plan_invalidations")
            self._count("cache_evictions", len(self._plans))
            self._plans.clear()
        if self._breaker_open or self._esc_counts:
            self._count("breaker_resets", len(self._breaker_open) or 1)
            self._breaker_open.clear()
            self._esc_counts.clear()
            self._real_esc.clear()

    def _initial_rung(self, key: BucketKey) -> str:
        """The ladder rung a fresh bucket plan starts at on the kernel
        path: the forced dispatch mode, else the measured tuning entry's
        where it decides one for this grid (it measured both lowerings at
        the bucket's tile: :func:`repro_torch.core.plan.
        tuned_dispatch_mode`), else the engine's budget rule; "oracle" on
        the plain path."""
        if not self.use_kernel:
            return "oracle"
        if self.dispatch_mode is not None:
            return self.dispatch_mode
        p, q, nb = self._grid(key)
        entry = _tcache.active_cache().lookup(
            backend=self.device.type, m=key.m, n=key.n, dtype=key.dtype)
        if entry is not None and entry.best.block == nb:
            mode = tuned_dispatch_mode(entry)
            if mode is not None:
                return mode
        return engine.resolve_dispatch_mode(
            p, q, nb, np.dtype(key.dtype).itemsize)

    def _plan_for(self, key: BucketKey, batch: int, *,
                  rung: str) -> _BucketPlan:
        self._check_tuning()
        cache_key = (key, batch, rung)
        plan = self._plans.get(cache_key)
        if plan is not None:
            self._plans.move_to_end(cache_key)
            self._count("cache_hits")
            return plan
        self._count("cache_misses")
        plan = self._build_plan(key, batch, rung=rung)
        self._plans[cache_key] = plan
        if len(self._plans) > self.cache_size:
            self._plans.popitem(last=False)
            self._count("cache_evictions")
        return plan

    def _build_plan(self, key: BucketKey, batch: int, *,
                    rung: str) -> _BucketPlan:
        """Prepare one bucket dispatch at ``rung``: the engine's dispatch
        guards for the rung (budgets, the ``vmem`` fault site), the
        kernel library, the device-resident tables of its lowering and
        of Q formation (the pinned staging buffer follows on the first
        host array staged).  The ONLY site that counts ``compiles`` —
        which is what makes the steady-state zero-rebuild claim
        testable."""
        _inject.check("compile", f"{key.m}x{key.n}:{rung}")
        use_kernel = rung in engine.DISPATCH_MODES
        dispatch_mode = rung if use_kernel else None
        p, q, nb = self._grid(key)
        dtype = as_torch_dtype(key.dtype)
        t0 = time.monotonic()
        mode = engine._check_dispatch(dtype, p, q, nb, use_kernel,
                                      dispatch_mode, batched=batch > 1)
        if use_kernel:
            if self.device.type == "cuda":
                _build.library()
            engine.prepare_dispatch(
                p, q, nb, dtype, self.device, mode, batch,
                qe=None if key.mode == "r" else min(p, q))
        self._count("compiles")
        self._observe("compile_seconds", time.monotonic() - t0)
        return _BucketPlan(key=key, batch=batch, grid=(p, q), nb=nb,
                           dispatch_mode=dispatch_mode, rung=rung,
                           dtype=dtype)

    def _plan_with_escalation(
            self, key: BucketKey, batch: int
            ) -> Tuple[Optional[_BucketPlan], str]:
        """Resolve a bucket's plan, walking the ladder on plan-build
        failures.  Returns ``(plan, rung)``; ``plan=None`` means the
        lapack rung (per-request fallback, nothing to prepare)."""
        if key in self._breaker_open:
            self._count("breaker_pinned_dispatches")
            return None, "lapack"
        rung = self._initial_rung(key)
        while True:
            try:
                return self._plan_for(key, batch, rung=rung), rung
            except Exception as e:  # noqa: BLE001 — the ladder decides
                below = _escalate.ladder_below(rung)
                nxt = below[0] if below else "lapack"
                if not (self.escalate and _escalate.escalates(
                        e, kernel=rung in _escalate.KERNEL_RUNGS,
                        to_kernel=nxt in _escalate.KERNEL_RUNGS)):
                    raise
                self._record_escalation(key, _escalate.record(
                    rung, nxt, _escalate.classify(e, "compile"), str(e),
                    injected=isinstance(e, _inject.InjectedFault)))
                if nxt == "lapack":
                    return None, "lapack"
                rung = nxt

    # ------------------------------------------------- failure machinery

    def _record_escalation(self, key: BucketKey,
                           esc: _escalate.Escalation) -> None:
        """Keep and count one hop; a hop counts towards the bucket's
        breaker unless it is a budget rejection between the kernel rungs
        (the only real hop between them: a planning verdict, not a
        failure).  A breaker that would pin a kernel-path bucket after a
        real failure raises instead."""
        self.escalations.append(esc)
        del self.escalations[:-200]            # bounded history
        self._count("escalations")
        if (esc.rung_from in _escalate.KERNEL_RUNGS
                and esc.rung_to in _escalate.KERNEL_RUNGS
                and not esc.injected):
            return
        self._esc_counts[key] = self._esc_counts.get(key, 0) + 1
        if not esc.injected:
            self._real_esc.add(key)
        if (self._esc_counts[key] >= self.breaker_threshold
                and key not in self._breaker_open):
            if self.use_kernel and key in self._real_esc:
                raise _escalate.KernelFault(
                    f"bucket {key.m}x{key.n} escalated "
                    f"{self._esc_counts[key]} times on the kernel path, "
                    f"not all of them injected (last: {esc.rule}: "
                    f"{esc.reason}); a kernel-path bucket is not pinned to "
                    f"torch.linalg.qr on a real failure")
            self._breaker_open.add(key)
            self._count("breaker_trips")
            _metrics.counter("robustness.breaker_open",
                             bucket=f"{key.m}x{key.n}").inc()
            stale = [ck for ck in self._plans if ck[0] == key]
            for ck in stale:
                del self._plans[ck]
            if stale:
                self._count("cache_evictions", len(stale))
            self.escalations.append(_escalate.Escalation(
                rung_from=esc.rung_to, rung_to="lapack",
                rule="breaker_open",
                reason=f"bucket {key.m}x{key.n} escalated "
                       f"{self._esc_counts[key]} times "
                       f"(threshold {self.breaker_threshold}); pinned to "
                       f"lapack"))

    def _recover_request(self, req: QRRequest, key: BucketKey,
                         start: str) -> QRResult:
        """Re-solve ONE request below ``start`` on its raw, unpadded
        payload, on the service's device (the per-slice recovery path)."""
        try:
            q, r, rung, escs = _escalate.solve_below(
                req.a, mode=key.mode, start=start,
                verify=self._verify_on(), tag=f"{key.m}x{key.n}",
                device=self.device)
        except _escalate.EscalationExhausted as e:
            for esc in e.escalations:
                self._record_escalation(key, esc)
            return QRResult(rid=req.rid, q=None, r=None,
                            error="escalation_exhausted")
        for esc in escs:
            self._record_escalation(key, esc)
        return QRResult(rid=req.rid, q=None if key.mode == "r" else q,
                        r=r)

    def _lapack_chunk(self, key: BucketKey, chunk: List[QRRequest]
                      ) -> Dict[int, QRResult]:
        """The breaker-pinned / bottom-rung chunk path: per-request
        ``torch.linalg.qr`` on the raw payloads, on the service's device
        — no padding, no plan, nothing left to fail but the input."""
        out: Dict[int, QRResult] = {}
        for req in chunk:
            q, r = _escalate.lapack_qr(req.a, key.mode, device=self.device)
            out[req.rid] = QRResult(rid=req.rid, q=q, r=r)
        return out

    # ---------------------------------------------------------- execution

    def _chunks(self) -> List[Tuple[BucketKey, List[QRRequest]]]:
        """Bucketize pending requests and split buckets into
        max_batch-sized dispatch chunks (submission order preserved)."""
        reqs, self._pending = self._pending, []
        out: List[Tuple[BucketKey, List[QRRequest]]] = []
        for key, rs in bucketize(reqs, self.policy).items():
            for i in range(0, len(rs), self.policy.max_batch):
                out.append((key, rs[i:i + self.policy.max_batch]))
        return out

    def _stage(self, plan: _BucketPlan, chunk: List[QRRequest]):
        """Zero-pad and stack one chunk's host arrays into its plan's
        staging buffer, then start their copy to the device: on a card a
        ``non_blocking`` copy on the side stream, whose event the dispatch
        waits on.  Returns ``(staged, event, on_device)``: ``on_device``
        lists the chunk's ``(slot, request)`` pairs that are already
        tensors on the device, whose slots stay zero here and which the
        dispatch copies in; a chunk of device tensors alone uploads
        nothing (``staged`` None).  Unfilled batch slots stay zero — a
        zero matrix factors to zero reflectors, so padding slots are
        compute waste only, priced by the fill-ratio stat, never a
        correctness risk."""
        on_device = [(s, req) for s, req in enumerate(chunk)
                     if isinstance(req.a, torch.Tensor)]
        if len(on_device) == len(chunk):
            return None, None, on_device
        if plan.staging is None:
            plan.staging = torch.zeros(
                (plan.batch, plan.key.m, plan.key.n), dtype=plan.dtype,
                pin_memory=self.device.type == "cuda")
        buf = plan.staging
        if plan.copied is not None:
            plan.copied.synchronize()   # the buffer's last copy has landed
        for s, req in enumerate(chunk):
            if isinstance(req.a, torch.Tensor):
                buf[s] = 0
                continue
            m, n = req.shape
            buf[s, :m, :n] = torch.from_numpy(req.a)
            buf[s, m:] = 0
            buf[s, :m, n:] = 0
        buf[len(chunk):] = 0
        if self._copy_stream is None:
            return buf.clone(), None, on_device
        with torch.cuda.stream(self._copy_stream):
            staged = buf.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        plan.copied = done
        return staged, done, on_device

    def _dispatch(self, plan: _BucketPlan, key: BucketKey, staged,
                  keep_input: bool, filled: int):
        """The bucket's one engine call on the compute stream (after its
        copy, and the device-to-device copies of its requests already on
        the device): the full padded factors, ``(r,)`` or ``(q, r)``, an
        event recorded after them (None on the CPU), and, with
        ``keep_input``, a copy of the padded stack for the health check
        (the engine may factor the stack in place).  The ``filled`` first
        slots hold requests; the wavefront lowerings skip the rest."""
        stack, copied, on_device = staged
        compute = None
        if self.device.type == "cuda":
            compute = torch.cuda.current_stream(self.device)
        if copied is not None:
            compute.wait_event(copied)
            stack.record_stream(compute)
        if stack is None:
            stack = torch.zeros((plan.batch, key.m, key.n),
                                dtype=plan.dtype, device=self.device)
        for s, req in on_device:
            m, n = req.shape
            stack[s, :m, :n].copy_(req.a)
        a_stack = stack.clone() if keep_input else None
        out = _factor_stack_padded(
            stack, p=plan.grid[0], q=plan.grid[1], nb=plan.nb,
            mode=key.mode, use_kernel=plan.rung in engine.DISPATCH_MODES,
            dispatch_mode=plan.dispatch_mode, filled=filled)
        if compute is None:
            return out, None, a_stack
        done = torch.cuda.Event()
        done.record(compute)
        return out, done, a_stack

    def flush(self) -> Dict[int, QRResult]:
        """Execute every pending request; returns ``{rid: QRResult}``.

        Software pipeline over dispatch chunks: chunk i's engine call is
        enqueued on the compute stream, then chunk i+1 is staged (host
        fill of its pinned buffer, copy on the side stream) while chunk i
        computes.  Health checks and escalations happen after every
        dispatch has been enqueued — a failing slice never stalls the
        healthy pipeline — and flush returns when the card has finished.

        Failure-atomic: if an exception escapes (escalation disabled or
        non-recoverable), every request not yet resolved to a result is
        restored to the pending queue before the exception propagates."""
        self._check_tuning()
        with _trace.span("serving.bucketize", service=self._sid):
            work = self._chunks()
        results: Dict[int, QRResult] = {}
        try:
            if work:
                self._flush_work(work, results)
        except BaseException:
            done = set(results)
            self._pending = [req for _, chunk in work for req in chunk
                             if req.rid not in done] + self._pending
            raise
        for rid, reason in self._quarantined.items():
            results[rid] = QRResult(rid=rid, q=None, r=None,
                                    error=f"quarantined:{reason}")
        self._quarantined.clear()
        return results

    def _flush_work(self, work, results: Dict[int, QRResult]) -> None:
        with _trace.span("serving.plan", service=self._sid,
                         chunks=len(work)):
            planned = [self._plan_with_escalation(
                key, pad_batch(len(chunk), max_batch=self.policy.max_batch))
                for key, chunk in work]
        verify_on = self._verify_on()
        kernel_chunks = [i for i, (plan, _) in enumerate(planned)
                         if plan is not None]
        staged: Dict[int, Tuple] = {}
        if kernel_chunks:
            i0 = kernel_chunks[0]
            staged[i0] = self._stage(planned[i0][0], work[i0][1])
        outs: Dict[int, Tuple] = {}
        for pos, i in enumerate(kernel_chunks):
            plan, rung = planned[i]
            key, chunk = work[i]
            tag = f"{key.m}x{key.n}:{rung}"
            with _trace.span("serving.dispatch", service=self._sid,
                             bucket=f"{key.m}x{key.n}", batch=plan.batch,
                             fill=len(chunk), rung=rung):
                try:
                    _inject.sleep(tag)
                    _inject.check("dispatch", tag)
                    out, done, a_stack = self._dispatch(
                        plan, key, staged.pop(i), keep_input=verify_on,
                        filled=len(chunk))
                    outs[i] = (_inject.corrupt_output(out, tag), done,
                               a_stack, out)
                except Exception as e:  # noqa: BLE001 — the ladder decides
                    if not (self.escalate and _escalate.escalates(
                            e, kernel=rung in _escalate.KERNEL_RUNGS)):
                        raise
                    # Dispatch raised before results existed: the whole
                    # chunk recovers per request below this rung.
                    self._record_escalation(key, _escalate.record(
                        rung, "per-request", _escalate.classify(
                            e, "dispatch"), str(e),
                        injected=isinstance(e, _inject.InjectedFault)))
                    for req in chunk:
                        results[req.rid] = self._recover_request(
                            req, key, rung)
                    planned[i] = (None, "recovered")
                if pos + 1 < len(kernel_chunks):
                    j = kernel_chunks[pos + 1]
                    staged[j] = self._stage(planned[j][0], work[j][1])
            if planned[i][1] == "recovered":
                continue
            self._count("dispatches")
            self._count("matrices_served", len(chunk))
            self._count("padded_slots", plan.batch - len(chunk))
            now = time.monotonic()
            for req in chunk:
                self._observe("queue_wait_seconds", now - req.t_submit)
            self._observe("bucket_fill", len(chunk) / plan.batch)
            real = sum(m * n for m, n in (r.shape for r in chunk))
            waste = 1.0 - real / (plan.batch * key.m * key.n)
            self._observe("padding_waste", waste, bucket=f"{key.m}x{key.n}")
        with _trace.span("serving.unpad", service=self._sid) as sp:
            for i, (key, chunk) in enumerate(work):
                plan, rung = planned[i]
                if rung == "recovered":
                    continue
                if plan is None:               # breaker-pinned / lapack
                    results.update(self._lapack_chunk(key, chunk))
                    self._count("dispatches")
                    self._count("matrices_served", len(chunk))
                    continue
                out, done, a_stack, clean = outs[i]
                try:
                    sp.sync(out)
                    if done is not None:
                        done.synchronize()
                except Exception as e:  # noqa: BLE001 — deferred runtime error
                    if not (self.escalate and _escalate.escalates(
                            e, kernel=rung in _escalate.KERNEL_RUNGS)):
                        raise
                    self._record_escalation(key, _escalate.record(
                        rung, "per-request",
                        _escalate.classify(e, "dispatch"), str(e),
                        injected=isinstance(e, _inject.InjectedFault)))
                    for req in chunk:
                        results[req.rid] = self._recover_request(
                            req, key, rung)
                    continue
                bad: Set[int] = set()
                if verify_on:
                    bad = self._verify_chunk(key, chunk, out, a_stack, rung,
                                             clean)
                now = time.monotonic()
                for s, req in enumerate(chunk):
                    if s in bad:
                        results[req.rid] = self._recover_request(
                            req, key, rung)
                        continue
                    m, n = req.shape
                    k = min(m, n)
                    if key.mode == "r":
                        q_mat, r_mat = None, out[0][s, :k, :n]
                    else:
                        q_mat, r_mat = out[0][s, :m, :k], out[1][s, :k, :n]
                    results[req.rid] = QRResult(rid=req.rid, q=q_mat,
                                                r=r_mat)
                    self._observe("latency_seconds", now - req.t_submit)

    def _verify_chunk(self, key: BucketKey, chunk: List[QRRequest], out,
                      a_stack: torch.Tensor, rung: str, clean) -> Set[int]:
        """Per-slice health check of one finished bucket: ONE batched
        pass over the padded stack on the device, host-side verdicts.  A
        failing slice is recorded (and escalated by the caller) alone —
        its bucket-mates are unaffected.  ``clean`` is the dispatch's
        output before the ``output`` fault site: a failing slice of a
        kernel rung that the site did not corrupt raises
        :class:`~repro_torch.robustness.escalate.KernelFault`."""
        kp = min(key.m, key.n)   # factors come back fully padded
        with _trace.span("serving.verify", service=self._sid,
                         bucket=f"{key.m}x{key.n}"):
            if key.mode == "r":
                reports = _verify.check_batch(
                    a_stack, None, out[0][:, :kp, :key.n])
            else:
                reports = _verify.check_batch(
                    a_stack, out[0][:, :, :kp], out[1][:, :kp, :key.n])
        bad: Set[int] = set()
        for s in range(len(chunk)):
            rep = reports[s]
            if rep.ok:
                continue
            bad.add(s)
            self._count("health_check_failures")
            what = (f"slice {s} ({chunk[s].shape[0]}x{chunk[s].shape[1]}): "
                    f"{rep.reason} residual={rep.residual:.3e} "
                    f"defect={rep.ortho_defect:.3e} tol={rep.tol:.3e}")
            injected = _escalate.output_corrupted(clean, out, s)
            _escalate.refuse_health_failure(
                rung in _escalate.KERNEL_RUNGS, injected,
                f"bucket {key.m}x{key.n}:{rung} {what}")
            self._record_escalation(key, _escalate.record(
                rung, "per-request", "health_check_failed", what,
                injected=injected))
        return bad

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, object]:
        """Serving counters: cache behavior, dispatch economy, padding
        waste, failure hardening.  ``bucket_fill_ratio`` is matrices
        served over batch slots dispatched (1.0 = every slot carried a
        real request); ``cache_hit_rate`` is plan-cache hits over
        lookups; ``breaker_open`` counts buckets currently pinned to the
        fallback path; ``plan_invalidations`` counts tuning-cache changes
        that dropped resident plans, ``breaker_resets`` the breakers they
        reset.

        Counters are a view over this instance's ``serving.*`` series in
        the process-global metrics registry (``service=<id>`` label)."""
        served = self._count_value("matrices_served")
        padded = self._count_value("padded_slots")
        hits = self._count_value("cache_hits")
        slots = served + padded
        lookups = hits + self._count_value("cache_misses")
        return dict(
            requests=self._count_value("requests"),
            matrices_served=served,
            dispatches=self._count_value("dispatches"),
            compiles=self._count_value("compiles"),
            cache_hits=hits,
            cache_misses=self._count_value("cache_misses"),
            cache_evictions=self._count_value("cache_evictions"),
            plan_invalidations=self._count_value("plan_invalidations"),
            breaker_resets=self._count_value("breaker_resets"),
            plans_cached=len(self._plans),
            padded_slots=padded,
            bucket_fill_ratio=(served / slots) if slots else 1.0,
            cache_hit_rate=(hits / lookups) if lookups else 0.0,
            quarantined=self._count_value("quarantined"),
            escalations=self._count_value("escalations"),
            health_check_failures=self._count_value(
                "health_check_failures"),
            breaker_trips=self._count_value("breaker_trips"),
            breaker_open=len(self._breaker_open),
        )
