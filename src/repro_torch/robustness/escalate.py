"""The degradation ladder: retry a failed request DOWN, deterministically.

Counterpart of the reference's ``repro.robustness.escalate``.  When a
dispatch fails — its plan build raised, the execution raised, or the
post-dispatch health check rejected the output — the request is not
lost and not poisoned: it re-runs on the next rung of a fixed ladder,
each hop recorded as a named reason and counted under
``robustness.escalations{from, to, reason}``:

    megakernel  ->  wavefront  ->  oracle  ->  lapack

  * ``megakernel``: one cooperative launch of the (batched) megakernel
    over the task table (fastest, most machinery in the blast radius);
  * ``wavefront``:  one kernel launch per DAG level and kind (the same
    task bodies, a simpler launch path);
  * ``oracle``:     the port's plain lowering of the same schedule
    (``use_kernel=False`` — no hand-written kernel at all), on the same
    device;
  * ``lapack``:     ``torch.linalg.qr`` on the raw, unpadded request (the
    one place the port calls it; if THIS fails verification the input is
    the problem, not the realization).

The rung names are the reference's, so counter labels compare equal.
The ladder is strictly monotone — a request never climbs back up — and
deterministic: the same failure on the same input takes the same hops.

Two rules are the port's own, so that a fault of a hand-written kernel
is never served by the plain lowering or by the library:

  * a failure to *build* the kernel library
    (:class:`repro_torch.kernels._build.BuildError`) is re-raised, never
    escalated — a missing toolchain must not quietly turn every request
    into a plain-PyTorch solve;
  * on a kernel rung (:data:`KERNEL_RUNGS`, or a planned ``qr()`` whose
    config runs the kernels) only an injected fault walks the ladder —
    an :class:`~repro_torch.robustness.inject.InjectedFault`, or a health
    check failure of an output the ``output`` site corrupted — and a
    budget rejection (:class:`repro_torch.core.engine.BudgetError`) moves
    ``megakernel -> wavefront``, from one kernel rung to the other.  A
    real launch error or a health check failure of a kernel's own output
    raises :class:`KernelFault` (or the error itself).  The reference's
    hops stay testable through :mod:`repro_torch.robustness.inject`.

Below the kernel rungs (``oracle``, ``lapack``) every failure escalates
as in the reference.

:class:`~repro_torch.serving.QRService` drives the ladder at bucket
granularity (with a per-bucket circuit breaker); :func:`checked_solve`
drives it for the plain ``qr()`` path.  Both emit through :func:`record`
so the counter namespace is uniform.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels._build import BuildError
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace
from repro_torch.robustness import inject as _inject
from repro_torch.robustness import verify as _verify

__all__ = [
    "Escalation",
    "EscalationExhausted",
    "KERNEL_RUNGS",
    "KernelFault",
    "LADDER",
    "checked_solve",
    "classify",
    "escalates",
    "ladder_below",
    "lapack_qr",
    "record",
    "solve_below",
]

#: The full ladder, fastest first.  Bucket plans start at whichever rung
#: the engine's auto rule (or a forced dispatch mode) picked for them;
#: the plain-lowering serving path starts at "oracle".
LADDER: Tuple[str, ...] = ("megakernel", "wavefront", "oracle", "lapack")

#: The rungs that run the hand-written kernels.
KERNEL_RUNGS: Tuple[str, ...] = LADDER[:2]


@dataclasses.dataclass(frozen=True)
class Escalation:
    """One recorded hop — the RouteDecision of the failure path.

    rule:   stable slug of WHY ("compile_failed", "dispatch_failed",
            "health_check_failed", "breaker_open", "injected_compile",
            ...) — the low-cardinality counter label
    reason: the concrete arithmetic/exception text behind the hop
    injected: the hop was caused by an armed fault (the fault harness),
            not by the realization itself
    """

    rung_from: str
    rung_to: str
    rule: str
    reason: str = ""
    injected: bool = False


class EscalationExhausted(RuntimeError):
    """Every rung failed; ``escalations`` holds the recorded hops."""

    def __init__(self, msg: str, escalations: Sequence[Escalation]):
        self.escalations = tuple(escalations)
        super().__init__(msg)


class KernelFault(RuntimeError):
    """A kernel rung's own output failed its health check (or a bucket on
    the kernel path kept failing): raised, never served by a rung below
    the kernels."""


def escalates(exc: BaseException, *, kernel: bool = False,
              to_kernel: bool = False) -> bool:
    """May the ladder degrade past ``exc``, raised on a kernel rung
    (``kernel``) towards a kernel rung (``to_kernel``) or not?  Never past
    a failed kernel-library build.  From a kernel rung only past an
    injected fault, or past a budget rejection that moves to the other
    kernel rung.  Below the kernel rungs past everything else."""
    if isinstance(exc, BuildError):
        return False
    if not kernel or isinstance(exc, _inject.InjectedFault):
        return True
    from repro_torch.core.engine import BudgetError

    return to_kernel and isinstance(exc, BudgetError)


def refuse_health_failure(kernel: bool, injected: bool, what: str) -> None:
    """Raise :class:`KernelFault` for a health check failure that may not
    walk the ladder: one of a kernel rung's own (not injected) output."""
    if kernel and not injected:
        raise KernelFault(f"a kernel's output failed its health check: "
                          f"{what}")


def output_corrupted(out, hit, index: Optional[int] = None) -> bool:
    """Did the ``output`` fault site corrupt ``out`` into ``hit`` (slice
    ``index`` of every factor, when given)?  ``hit is out`` when no fault
    fired: :func:`repro_torch.robustness.inject.corrupt_output` copies
    what it corrupts."""
    if hit is out:
        return False
    xs = out if isinstance(out, (tuple, list)) else (out,)
    ys = hit if isinstance(hit, (tuple, list)) else (hit,)
    for x, y in zip(xs, ys):
        if x is None or x is y:
            continue
        if index is not None:
            x, y = x[index], y[index]
        if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
            return True
    return False


def classify(exc: BaseException, stage: str) -> str:
    """Stable slug for a failure: injected faults keep their site name
    (so chaos assertions can tell injected from organic), everything
    else is named by the stage that raised."""
    if isinstance(exc, _inject.InjectedFault):
        return f"injected_{exc.site}"
    return f"{stage}_failed"


def record(rung_from: str, rung_to: str, rule: str,
           reason: str = "", injected: bool = False) -> Escalation:
    """Emit the ``robustness.escalations{from, to, reason}`` counter and
    return the hop record."""
    _metrics.counter("robustness.escalations",
                     **{"from": rung_from, "to": rung_to,
                        "reason": rule}).inc()
    return Escalation(rung_from=rung_from, rung_to=rung_to, rule=rule,
                      reason=reason, injected=injected)


def ladder_below(rung: str) -> Tuple[str, ...]:
    """The rungs strictly below ``rung`` (unknown rungs — e.g. the
    api-path's "planned" pseudo-rung — see the whole ladder's safe
    tail: oracle then lapack)."""
    if rung in LADDER:
        return LADDER[LADDER.index(rung) + 1:]
    return LADDER[2:]


def _tensor(a, device=None) -> torch.Tensor:
    """``a`` as a tensor: a tensor stays where it is (or moves to an
    explicit ``device``); an array goes to ``device``, "cuda" unless the
    caller asks for the CPU."""
    if isinstance(a, torch.Tensor) and device is None:
        return a
    from repro_torch.core.plan import resolve_device

    return torch.as_tensor(a, device=resolve_device(device))


def lapack_qr(a, mode: str = "reduced", *, device=None):
    """The bottom rung: ``torch.linalg.qr`` on the raw request, on its
    device.  Returns ``(q, r)`` with ``q=None`` for mode="r"."""
    a = _tensor(a, device)
    if mode == "r":
        return None, torch.linalg.qr(a, mode="r")[1]
    return torch.linalg.qr(a, mode="reduced")


def _run_rung(rung: str, fn: Callable, tag: str):
    """Execute one rung with the dispatch-site injection hook armed."""
    _inject.check("dispatch", f"{tag}:{rung}")
    return fn()


def _health(a, q, r, mode: str) -> _verify.HealthReport:
    if mode == "r" or q is None:
        return _verify.check_r(a, r)
    return _verify.check_qr(a, q, r)


def solve_below(a, *, mode: str = "reduced", start: str = "oracle",
                verify: bool = True, tag: str = "request", device=None
                ) -> Tuple[Optional[torch.Tensor], torch.Tensor, str,
                           List[Escalation]]:
    """Re-solve ONE raw (unpadded) request on the rungs below ``start``,
    on ``device`` (default: the tensor's own; an array goes to "cuda").

    This is the per-request recovery path: when a batched dispatch's
    health check flags a single slice, that slice alone walks down from
    the bucket's rung — ``oracle`` re-solves it through the planner's
    plain lowering, ``lapack`` through ``torch.linalg.qr`` — verifying
    each attempt (when ``verify``).  Returns ``(q, r, rung_used,
    escalations)``; raises :class:`EscalationExhausted` if every rung
    below raises (a verification failure at the bottom rung returns the
    lapack factors anyway — at that point the INPUT is suspect, which
    admission should have caught, and the caller marks the result).
    """
    a = _tensor(a, device)
    escalations: List[Escalation] = []
    prev = start
    rungs = ladder_below(start)
    for i, rung in enumerate(rungs):
        try:
            with _trace.span("robustness.rung", rung=rung, tag=tag):
                if rung == "lapack":
                    q, r = _run_rung(rung, lambda: lapack_qr(a, mode), tag)
                elif rung == "oracle":
                    q, r = _run_rung(
                        rung, lambda: _oracle_qr(a, mode), tag)
                else:
                    # Kernel rungs need a prepared bucket plan; a raw
                    # single request re-solve skips straight to the
                    # kernel-free realizations.
                    continue
        except Exception as e:  # noqa: BLE001 — every rung failure degrades
            if not escalates(e):
                raise
            escalations.append(record(
                prev, _next(rungs, i), classify(e, "dispatch"), str(e),
                injected=isinstance(e, _inject.InjectedFault)))
            prev = rung
            continue
        if verify:
            rep = _health(a, q, r, mode)
            if not rep.ok:
                if rung == "lapack":
                    return q, r, rung, escalations  # input is the suspect
                escalations.append(record(
                    rung, _next(rungs, i), "health_check_failed",
                    f"{rep.reason}: residual={rep.residual:.3e} "
                    f"defect={rep.ortho_defect:.3e} tol={rep.tol:.3e}"))
                prev = rung
                continue
        return q, r, rung, escalations
    raise EscalationExhausted(
        f"every rung below {start!r} failed for {tag}", escalations)


def _next(rungs: Sequence[str], i: int) -> str:
    return rungs[i + 1] if i + 1 < len(rungs) else "none"


def _oracle_qr(a: torch.Tensor, mode: str):
    """The planner's kernel-free lowering of one request, on its
    device."""
    from repro_torch.core.plan import QRConfig, plan

    cfg = QRConfig(use_kernel=False,
                   mode="r" if mode == "r" else "reduced")
    out = plan(a.shape, a.dtype, cfg, backend=a.device.type).solve(a)
    if mode == "r":
        return None, out
    return out


def checked_solve(solver, a: torch.Tensor):
    """The plain-``qr()`` escalation path: run the planned solver,
    health-check the result, and walk the ladder on failure.

    Only called when the verify knob resolves ON — the verify-off path in
    :func:`repro_torch.core.api.qr` calls ``solver.solve`` directly, so
    disabling verification leaves the solve exactly as it was.  A stack
    (``a.ndim > 2``) is checked slice by slice and only the failed slices
    re-solve.  When the plan runs the kernels, only injected faults walk
    the ladder (see the module doc): a real failure raises."""
    mode = solver.config.mode
    kernel = bool(solver.config.use_kernel)
    tag = f"qr:{'x'.join(str(d) for d in a.shape)}"
    try:
        out = _run_rung("planned", lambda: solver.solve(a), tag)
    except Exception as e:  # noqa: BLE001
        if not escalates(e, kernel=kernel):
            raise
        record("planned", "oracle", classify(e, "dispatch"), str(e),
               injected=isinstance(e, _inject.InjectedFault))
        q, r, _, _ = solve_below(a, mode=mode, start="planned", tag=tag)
        return r if mode == "r" else (q, r)
    hit = _inject.corrupt_output(out, tag)
    q, r = (None, hit) if mode == "r" else hit
    if a.ndim == 2:
        rep = _health(a, q, r, mode)
        if rep.ok:
            return hit
        injected = output_corrupted(out, hit)
        refuse_health_failure(kernel, injected, f"{tag}: {rep.reason}")
        record("planned", "oracle", "health_check_failed", rep.reason or "",
               injected=injected)
        q, r, _, _ = solve_below(a, mode=mode, start="planned",
                                 verify=True, tag=tag)
        return r if mode == "r" else (q, r)
    # A stack: verify slice by slice over the flattened leading dims.
    lead, (m, n) = tuple(a.shape[:-2]), tuple(a.shape[-2:])
    flat = (lambda x: None if x is None
            else x.reshape((-1,) + tuple(x.shape[-2:])))
    a3, r3, q3 = flat(a), flat(r), flat(q)
    reports = _verify.check_batch(a3, q3, r3)
    bad = [i for i, rp in enumerate(reports) if not rp.ok]
    if not bad:
        return hit
    out3 = ((flat(out),) if mode == "r" else tuple(map(flat, out)))
    hit3 = ((r3,) if mode == "r" else (q3, r3))
    injected = hit is not out and all(
        output_corrupted(out3, hit3, i) for i in bad)
    refuse_health_failure(kernel, injected,
                          f"{tag} slices {bad}: {reports[bad[0]].reason}")
    record("planned", "oracle", "health_check_failed",
           f"slices {bad}: {reports[bad[0]].reason}", injected=injected)
    r3 = r3.clone()
    q3 = None if q3 is None else q3.clone()
    for i in bad:
        qi, ri, _, _ = solve_below(a3[i], mode=mode, start="planned",
                                   verify=True, tag=f"{tag}[{i}]")
        r3[i] = ri
        if q3 is not None and qi is not None:
            q3[i] = qi
    r = r3.reshape(lead + tuple(r3.shape[-2:]))
    if q3 is None:
        return r
    return q3.reshape(lead + tuple(q3.shape[-2:])), r
