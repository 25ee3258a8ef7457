"""Numerical health + failure hardening for the QR stack.

Counterpart of the reference's ``repro.robustness``.  Four small modules,
one contract — a dispatch either returns a result that would pass the
conformance suite, or the failure is named, counted, and recovered from:

  * :mod:`repro_torch.robustness.guards`   — input admission
    (``QRService.submit`` quarantines non-finite / malformed payloads
    before they can poison a padded bucket);
  * :mod:`repro_torch.robustness.verify`   — post-dispatch health checks
    (relative residual + orthogonality defect against the conformance
    tolerance rule, per slice on batched dispatches, in float64 on the
    result's device), behind ``QRConfig.verify`` / ``$REPRO_VERIFY``;
  * :mod:`repro_torch.robustness.escalate` — the deterministic
    degradation ladder megakernel -> wavefront -> oracle -> lapack, every
    hop a named reason plus a ``robustness.escalations{from,to,reason}``
    counter (the serving layer adds a per-bucket circuit breaker on top);
    a failed kernel-library build is re-raised, never escalated;
  * :mod:`repro_torch.robustness.inject`   — the deterministic fault
    harness (seeded NaN/Inf corruption, forced plan-build / budget
    failures, per-bucket latency) that proves each of those paths
    actually fires.

The whole layer is free when off: admission is one O(mn) host scan,
verification resolves on the host before any work, and injection hooks
are a single global read.
"""

from repro_torch.robustness.guards import (AdmissionError, AdmissionPolicy,
                                           admit, estimate_condition)
from repro_torch.robustness.verify import (HealthReport, check_batch,
                                           check_ortho, check_ortho_batch,
                                           check_qr, check_r, tolerance,
                                           verify_enabled)
from repro_torch.robustness.escalate import (LADDER, Escalation,
                                             EscalationExhausted,
                                             checked_solve, ladder_below,
                                             lapack_qr, record, solve_below)
from repro_torch.robustness.inject import Fault, InjectedFault

__all__ = [
    "AdmissionError",
    "AdmissionPolicy",
    "Escalation",
    "EscalationExhausted",
    "Fault",
    "HealthReport",
    "InjectedFault",
    "LADDER",
    "admit",
    "check_batch",
    "check_ortho",
    "check_ortho_batch",
    "check_qr",
    "check_r",
    "checked_solve",
    "estimate_condition",
    "ladder_below",
    "lapack_qr",
    "record",
    "solve_below",
    "tolerance",
    "verify_enabled",
]
