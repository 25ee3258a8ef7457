"""Batched optimizer-step orthogonalization: one dispatch per shape class.

Counterpart of the reference's ``repro.optim.batched_ortho``.  A Muon
step orthogonalizes dozens of independent momentum matrices; this module
collects every 2-D matrix of the step, groups them into **shape
classes** with the serving layer's
:func:`repro_torch.serving.bucketing.group_shape_classes` (under the
tile-granularity optimizer policy ``DEFAULT_ORTHO_POLICY``), zero-pads
and stacks each class, plans the stack once through
:func:`repro_torch.core.plan.plan`, and orthogonalizes the whole class in
one planned call: on ``"cuda"`` the tiled route runs one batched
megakernel launch (or, past the table budget, one wavefront launch per
level and kind for the whole stack) and the panel route one launch a
panel step for the stack.

Zero padding is numerically free: trailing zero columns never touch the
leading ``n`` columns of Q and zero rows factor to zero reflector
entries, so the ``[:m, :n]`` slice of the padded sign-fixed thin Q is
the member's sign-fixed thin Q.

Routing per class (:class:`OrthoPlan`): ``"batched"`` (the class as one
``(B, M, N)`` problem, with the planner's explain trail) or
``"leafwise"`` (per-matrix :func:`repro_torch.optim.qr_muon.
qr_orthogonalize_2d`: singleton classes, and shapes whose class plan
fails).

The robustness seam follows the port's rule for kernels
(:mod:`repro_torch.robustness.escalate`): with verification on, a slice
the ``output`` fault site corrupted re-solves leafwise, counted under
``robustness.escalations{from=batched, to=leafwise}`` and
``optim.ortho_escalations``; a slice of a class that ran on the kernels
whose own output fails its health check raises
:class:`~repro_torch.robustness.escalate.KernelFault` — the plain
leafwise route never hides a broken kernel.  A plain-lowering class
escalates as the reference's does.

:func:`batched_orthogonalize` runs on ``"cuda"`` unless ``device="cpu"``
and raises without a card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.plan import (PlanExplain, QRConfig, as_torch_dtype,
                                   plan as qr_plan, resolve_device)
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import trace as _trace
from repro_torch.serving.bucketing import (BucketKey, BucketingPolicy,
                                           group_shape_classes)

__all__ = [
    "DEFAULT_ORTHO_POLICY",
    "OrthoClassPlan",
    "OrthoPlan",
    "batched_orthogonalize",
    "plan_batched_ortho",
]

# Optimizer-side bucketing: tile 16, tile-granularity padding only
# (max_waste=0) — an optimizer step's shapes are a small static set whose
# classes form from exactly repeated layer shapes, so coarser edges buy
# no merging and only burn cubic flops (576 stays 576).  max_batch is per
# class.  The reference's policy.
DEFAULT_ORTHO_POLICY = BucketingPolicy(tile=16, max_waste=0.0,
                                       max_batch=512)


@dataclasses.dataclass(frozen=True)
class OrthoClassPlan:
    """Routing for one shape class of the step: the flat members it owns,
    batched or leafwise, and why.  ``key`` is the padded, tall-oriented
    class (wide members are transposed before classing)."""

    key: BucketKey
    members: Tuple[int, ...]
    route: str                        # "batched" | "leafwise"
    reason: str
    method: Optional[str] = None      # resolved method (batched only)
    dispatch_mode: Optional[str] = None
    use_kernel: Optional[bool] = None
    explain: Optional[PlanExplain] = dataclasses.field(default=None,
                                                       compare=False)

    @property
    def dispatches(self) -> int:
        return 1 if self.route == "batched" else len(self.members)


@dataclasses.dataclass(frozen=True)
class OrthoPlan:
    """The step's dispatch plan: every 2-D matrix of every leaf in exactly
    one shape class.  Members are flat: leaf ``i``'s lead dims unroll
    row-major, leaves concatenate in input order; ``member_leaf[j]`` maps
    member ``j`` back to its leaf."""

    classes: Tuple[OrthoClassPlan, ...]
    n_leaves: int
    n_matrices: int
    member_leaf: Tuple[int, ...]

    @property
    def dispatches(self) -> int:
        return sum(c.dispatches for c in self.classes)

    @property
    def batched_matrices(self) -> int:
        return sum(len(c.members) for c in self.classes
                   if c.route == "batched")

    @property
    def leafwise_matrices(self) -> int:
        return sum(len(c.members) for c in self.classes
                   if c.route == "leafwise")


def _member_geometry(shape, dtype):
    """``(lead, m, n, transpose, compute_dtype)`` of one leaf's members,
    oriented tall; lead is the unrolled stack depth."""
    m, n = int(shape[-2]), int(shape[-1])
    lead = math.prod(int(d) for d in shape[:-2])
    transpose = m < n
    if transpose:
        m, n = n, m
    compute = torch.promote_types(as_torch_dtype(dtype), torch.float32)
    return lead, m, n, transpose, compute


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def plan_batched_ortho(leaves: Sequence[Tuple], *,
                       policy: Optional[BucketingPolicy] = None,
                       config: Optional[QRConfig] = None,
                       backend: Optional[str] = None) -> OrthoPlan:
    """Pure shape-class routing of one step's orthogonalization.
    ``leaves`` holds one ``(shape, dtype)`` pair per >= 2-D momentum leaf;
    ``backend`` ("cuda", the default, or "cpu") is where the classes will
    run, as in :func:`repro_torch.core.plan.plan`."""
    policy = DEFAULT_ORTHO_POLICY if policy is None else policy
    base = QRConfig() if config is None else config
    base = base.replace(mode="reduced", sign_fix=True)

    member_shapes: List[Tuple[int, int, str]] = []
    member_leaf: List[int] = []
    for li, (shape, dtype) in enumerate(leaves):
        if len(shape) < 2:
            raise ValueError(
                f"orthogonalization needs matrix leaves, got shape {shape}")
        lead, m, n, _, compute = _member_geometry(shape, dtype)
        member_shapes.extend([(m, n, _dtype_name(compute))] * lead)
        member_leaf.extend([li] * lead)

    classes: List[OrthoClassPlan] = []
    for key, members in group_shape_classes(member_shapes, policy).items():
        b = len(members)
        if b == 1:
            classes.append(OrthoClassPlan(
                key=key, members=tuple(members), route="leafwise",
                reason="singleton_class: a batch of one amortizes no "
                       "dispatch — per-leaf qr_orthogonalize_2d"))
            continue
        try:
            solver = qr_plan((b, key.m, key.n), key.dtype, base,
                             backend=backend, explain=True)
        except (ValueError, ImportError) as e:
            classes.append(OrthoClassPlan(
                key=key, members=tuple(members), route="leafwise",
                reason=f"plan_failed: {e}"))
            continue
        sel = solver.explain.selected
        classes.append(OrthoClassPlan(
            key=key, members=tuple(members), route="batched",
            reason=f"{sel.rule}: {sel.reason}" if sel is not None else
                   "planned", method=solver.config.method,
            dispatch_mode=solver.config.dispatch_mode,
            use_kernel=bool(solver.config.use_kernel),
            explain=solver.explain))
    return OrthoPlan(classes=tuple(classes), n_leaves=len(leaves),
                     n_matrices=len(member_shapes),
                     member_leaf=tuple(member_leaf))


def _default_fallback(a: torch.Tensor) -> torch.Tensor:
    from repro_torch.optim.qr_muon import qr_orthogonalize_2d

    return qr_orthogonalize_2d(a)


def _post_dispatch(q_stack: torch.Tensor, label: str, *,
                   verify: Optional[bool], kernel: bool):
    """Robustness seam of one class dispatch: the ``output`` fault hook,
    then (verification on) a per-slice orthogonality health check.
    Returns ``(q_stack, bad_slots)``: the slots to re-solve leafwise, each
    hop counted.  A failed slot the fault site did not corrupt, of a class
    that ran on the kernels, raises ``KernelFault``."""
    from repro_torch.robustness import escalate as _escalate
    from repro_torch.robustness import inject as _inject
    from repro_torch.robustness.verify import check_ortho_batch, verify_enabled

    out = q_stack
    if _inject.enabled():
        q_stack = _inject.corrupt_output(q_stack, f"ortho:{label}")
    if not verify_enabled(verify):
        return q_stack, frozenset()
    bad = set()
    for slot, rep in enumerate(check_ortho_batch(q_stack)):
        if rep.ok:
            continue
        what = (f"class {label} slot {slot}: {rep.reason} "
                f"defect={rep.ortho_defect:.3e} tol={rep.tol:.3e}")
        injected = _escalate.output_corrupted(out, q_stack, slot)
        _escalate.refuse_health_failure(kernel, injected, what)
        bad.add(slot)
        _escalate.record("batched", "leafwise", "health_check_failed", what,
                         injected=injected)
        _metrics.counter("optim.ortho_escalations", bucket=label).inc()
    return q_stack, bad


def batched_orthogonalize(leaves: Sequence[torch.Tensor], *,
                          policy: Optional[BucketingPolicy] = None,
                          config: Optional[QRConfig] = None,
                          fallback: Optional[Callable] = None,
                          ortho_plan: Optional[OrthoPlan] = None,
                          device=None) -> List[torch.Tensor]:
    """Sign-fixed thin Q of every matrix in ``leaves``, dispatched per
    shape class, on ``device`` (``"cuda"`` unless the caller asks for the
    CPU; the leaves move there).

    Each leaf is a >= 2-D tensor (lead dims are independent matrices); the
    result list matches input shapes and dtypes.  ``fallback`` handles
    leafwise members (default: ``qr_orthogonalize_2d``); ``ortho_plan``
    reuses a plan built from these leaves' shapes and dtypes."""
    dev = resolve_device(device)
    leaves = [torch.as_tensor(l, device=dev) for l in leaves]
    backend = dev.type
    policy = DEFAULT_ORTHO_POLICY if policy is None else policy
    if ortho_plan is None:
        ortho_plan = plan_batched_ortho(
            [(tuple(l.shape), l.dtype) for l in leaves],
            policy=policy, config=config, backend=backend)
    base = QRConfig() if config is None else config
    base = base.replace(mode="reduced", sign_fix=True)
    fallback = _default_fallback if fallback is None else fallback

    # Flat member views, in the plan's member index space.
    members: List[torch.Tensor] = []
    geom: List[Tuple[int, int, bool]] = []
    for leaf in leaves:
        lead, m, n, transpose, _ = _member_geometry(leaf.shape, leaf.dtype)
        stack = leaf.reshape((lead,) + tuple(leaf.shape[-2:]))
        for s in range(lead):
            members.append(stack[s].mT if transpose else stack[s])
            geom.append((m, n, transpose))

    def dtype_of(j):
        return leaves[ortho_plan.member_leaf[j]].dtype

    out: List[Optional[torch.Tensor]] = [None] * len(members)
    with _trace.span("optim.batched_ortho", classes=len(ortho_plan.classes),
                     matrices=ortho_plan.n_matrices):
        for cls in ortho_plan.classes:
            _metrics.counter("optim.ortho_classes", route=cls.route).inc()
            _metrics.counter("optim.ortho_dispatches",
                             route=cls.route).inc(cls.dispatches)
            _metrics.counter("optim.ortho_matrices",
                             route=cls.route).inc(len(cls.members))
            label = f"{cls.key.m}x{cls.key.n}"
            if cls.route == "leafwise":
                with _trace.span("optim.ortho_class.leafwise", bucket=label,
                                 route="leafwise", batch=len(cls.members)):
                    for j in cls.members:
                        # The member in its own orientation, and its Q
                        # kept so (the reference transposes a wide
                        # member's Q twice here: ROADMAP C6).
                        out[j] = fallback(members[j].mT if geom[j][2]
                                          else members[j])
                continue
            compute = as_torch_dtype(cls.key.dtype)
            solver = qr_plan((len(cls.members), cls.key.m, cls.key.n),
                             compute, base, backend=backend)
            with _trace.span("optim.ortho_class.batched", bucket=label,
                             route="batched", batch=len(cls.members),
                             method=solver.config.method):
                with _trace.span("optim.ortho_stack"):
                    stacked = torch.zeros(
                        (len(cls.members), cls.key.m, cls.key.n),
                        dtype=compute, device=dev)
                    for slot, j in enumerate(cls.members):
                        m, n, _ = geom[j]
                        stacked[slot, :m, :n] = members[j]
                q_stack = solver.orthogonalize(stacked)
                q_stack, bad = _post_dispatch(
                    q_stack, label, verify=base.verify,
                    kernel=bool(solver.config.use_kernel))
                with _trace.span("optim.ortho_unstack"):
                    for slot, j in enumerate(cls.members):
                        m, n, transpose = geom[j]
                        if slot in bad:
                            # The flagged slice alone re-solves leafwise;
                            # its class-mates ship as they are.
                            q = fallback(members[j].to(compute)).to(
                                dtype_of(j))
                        else:
                            q = q_stack[slot, :m, :n].to(dtype_of(j))
                        out[j] = q.mT if transpose else q

    # Scatter members back into leaf-shaped stacks.
    results: List[torch.Tensor] = []
    pos = 0
    for leaf in leaves:
        lead = _member_geometry(leaf.shape, leaf.dtype)[0]
        mats = out[pos:pos + lead]
        pos += lead
        results.append(torch.stack(mats).reshape(leaf.shape)
                       if leaf.ndim > 2 else mats[0])
    return results
