"""Typed QR planning: QRConfig, the method registry, routing, QRSolver.

Counterpart of the reference's ``repro.core.plan``, on PyTorch.  The
planner's backend string is ``"cuda"`` or ``"cpu"``: it names the device
the solve runs on.  Routing follows the reference rule for rule
(:data:`_ROUTE_RULES`, the same decision slugs and reasons), with the
tiled floor of 256 on ``"cuda"`` as on the reference's TPU.  Every
method of the reference is registered.  A method that registers a packed
``factor`` solves every mode through :func:`_default_solve`, the
reference's.  The sharded routing rule counts the ranks of the default
``torch.distributed`` process group (1 without one), the ranks a
``sharded_tiled`` solve runs over, where the reference counts
``jax.local_device_count()``.

The ``tuned`` rule consults the measured tuning cache
(:mod:`repro_torch.tuning`) as the reference's does.  Deliberate
differences from the reference, each recorded in ROADMAP §C:

  * a tuned method that cannot honor ``use_kernel=True`` rejects the
    ``tuned`` rule and routing falls through (the reference plans it and
    raises, ROADMAP C3); so does, on ``"cuda"``, a kernel-backed pick
    measured on its plain lowering, unless ``use_kernel=False`` asks for
    that lowering;
  * a tuned ``dispatch_mode`` applies only when the entry measured both
    lowerings at its block; otherwise the engine's budget rule resolves
    the mode for the member's own grid (the reference overlays the
    class edge's mode on every member, ROADMAP C7);
  * ``use_kernel=None`` on ``"cuda"`` resolves to True for a method whose
    kernels are ported, and raises when their per-task working set
    exceeds :data:`DEFAULT_SMEM_BUDGET`, one H100 block's shared memory:
    the plain lowering runs only when asked for (``use_kernel=False``) or
    on the CPU;
  * a forced ``dispatch_mode="megakernel"`` whose task table exceeds
    :data:`DEFAULT_TABLE_BUDGET` raises when planned (the reference raises
    when the engine runs);
  * a ``(..., B, m, n)`` input reaches a method's ``solve_batched`` as one
    ``(B', m, n)`` stack of all its matrices (the reference vmaps the
    dimensions before the last three);
  * on the kernel path the panel kernel factors a wide panel's ``min(m,
    n)`` pivot columns and returns that many taus (the reference's
    returns n), and Q (and ``lstsq``'s Q^T b) is applied panel by panel
    through the trailing kernel instead of one reflector at a time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import DEFAULT_SMEM_BUDGET, DEFAULT_TABLE_BUDGET
from repro_torch.observability import metrics as _metrics

__all__ = [
    "QRConfig",
    "MethodSpec",
    "KernelPolicy",
    "QRSolver",
    "PlanExplain",
    "RouteDecision",
    "plan",
    "select_method",
    "register_method",
    "register_kernel_policy",
    "get_method",
    "available_methods",
    "kernel_smem_budget",
    "as_torch_dtype",
    "resolve_device",
    "DEFAULT_SMEM_BUDGET",
    "DEFAULT_TABLE_BUDGET",
    "sign_fix_qr",
    "sign_fix_r",
    "tuned_dispatch_mode",
    "default_use_kernel",
]

Tensor = torch.Tensor

_MODES = ("reduced", "r", "full")
_Q_METHODS = ("formq", "solve")
_BACKENDS = ("cuda", "cpu")

# Auto-routing thresholds, the reference's (see its plan.py for the why).
_TILED_MIN_DIM = 256
_TILED_MAX_DIM = 2048
_TILED_MAX_ASPECT = 4.0
_TILED_MIN_DIM_CPU = 512
_SHARDED_MAX_DOM_FACTOR = 8


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks otherwise.  Raises when CUDA is asked for (or defaulted to) and
    no card is present — it never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if dev.type not in _BACKENDS:
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


@dataclasses.dataclass(frozen=True)
class QRConfig:
    """Hashable description of a QR realization — the reference's fields
    and checks.  ``method="auto"`` / ``use_kernel=None`` / ``nblocks=None``
    are resolved by :func:`plan`; ``dispatch_mode`` is the engine lowering
    ("wavefront", "megakernel", None = auto);
    ``use_tuning_cache`` lets the ``tuned`` rule consult the measured
    cache;
    ``verify`` turns on the health-checked solve of :func:`repro_torch.qr`
    (True / False, or None for the ``REPRO_VERIFY`` environment
    default)."""

    method: str = "auto"
    block: int = 32
    use_kernel: Optional[bool] = None
    nblocks: Optional[int] = None
    precision: Optional[str] = None
    sign_fix: bool = False
    mode: str = "reduced"
    q_method: str = "formq"
    refine: bool = True
    ndomains: Optional[int] = None
    dispatch_mode: Optional[str] = None
    use_tuning_cache: bool = True
    verify: Optional[bool] = None

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown mode {self.mode!r}; expected one of {_MODES}")
        if self.dispatch_mode not in (None, "wavefront", "megakernel"):
            raise ValueError(
                f"unknown dispatch_mode {self.dispatch_mode!r}; expected "
                "'wavefront', 'megakernel', or None (auto)")
        if self.q_method not in _Q_METHODS:
            raise ValueError(
                f"unknown q_method {self.q_method!r}; expected one of {_Q_METHODS}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if self.nblocks is not None and self.nblocks < 1:
            raise ValueError(f"nblocks must be >= 1, got {self.nblocks}")
        if self.ndomains is not None and self.ndomains < 1:
            raise ValueError(f"ndomains must be >= 1, got {self.ndomains}")
        if self.verify not in (None, True, False):
            raise ValueError(
                f"verify must be True, False, or None (env default), "
                f"got {self.verify!r}")

    def replace(self, **changes) -> "QRConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """Capability metadata + entry points of one registered realization.

    factor:  ``(a_bmn, cfg) -> (packed, taus)`` in the LAPACK packed
             layout, on a ``(B, m, n)`` stack; a method with ``solve``
             None is solved from it by :func:`_default_solve`, a whole
             stack at once
    solve:   ``(a, cfg) -> (q, r) | r`` honoring cfg.mode/sign_fix
    solve_batched: optional ``(a_bmn, cfg) -> (q, r) | r`` over a leading
             batch axis; :meth:`QRSolver.solve` hands it every stacked
             input as one stack (the tiled method factors it in one
             batched engine call)
    resolve: optional ``(m, n, cfg, *, dtype, explain) -> cfg`` hook
    smem_bytes: optional ``(m, n, cfg, itemsize) -> bytes``, the largest
             dynamic shared memory per CTA that the kernel path launches
             with at that element width, read by the ``use_kernel=None``
             rule (it may raise, naming a cap of the kernels)
    kernel_policy: the :class:`KernelPolicy` whose budget gates it
    min_aspect: required m/n ratio (TSQR needs tall-skinny input)
    """

    name: str
    factor: Optional[Callable] = None
    solve: Optional[Callable] = None
    solve_batched: Optional[Callable] = None
    resolve: Optional[Callable] = None
    supports_full_q: bool = True
    min_aspect: float = 0.0
    batched: bool = True
    kernel_backed: bool = False
    smem_bytes: Optional[Callable] = None
    kernel_policy: str = "mht_panel"
    description: str = ""


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """The per-block shared-memory budget a kernel backend's working set
    must fit (the reference's VMEM budget)."""

    name: str
    smem_budget: int = DEFAULT_SMEM_BUDGET


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """One machine-readable routing (or resolve) decision: a stable rule
    slug, an outcome ("selected" / "rejected" / "fallback" / "resolved"),
    and the threshold arithmetic that fired."""

    rule: str
    outcome: str
    reason: str


@dataclasses.dataclass(frozen=True)
class PlanExplain:
    """Why :func:`plan` chose what it chose — ``plan(..., explain=True)``."""

    shape: Tuple[int, int]
    dtype: str
    backend: str
    ndevices: int
    requested_method: str
    method: str
    use_kernel: bool
    dispatch_mode: Optional[str]
    decisions: Tuple[RouteDecision, ...]
    fallback_reasons: Tuple[str, ...]

    def decision(self, rule: str) -> Optional[RouteDecision]:
        """The first decision recorded for ``rule`` (None if absent)."""
        for d in self.decisions:
            if d.rule == rule:
                return d
        return None

    @property
    def selected(self) -> Optional[RouteDecision]:
        """The decision that chose the method."""
        for d in self.decisions:
            if d.outcome == "selected":
                return d
        return None


_REGISTRY: Dict[str, MethodSpec] = {}
_KERNEL_POLICIES: Dict[str, KernelPolicy] = {}
_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Import the ported realizations so they self-register."""
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    _BUILTINS_LOADED = True
    import repro_torch.core.blocked  # noqa: F401
    import repro_torch.core.distgraph  # noqa: F401
    import repro_torch.core.householder  # noqa: F401
    import repro_torch.core.mht  # noqa: F401
    import repro_torch.core.tilegraph  # noqa: F401
    import repro_torch.core.tsqr  # noqa: F401
    import repro_torch.kernels.ops  # noqa: F401


def register_method(spec: MethodSpec) -> MethodSpec:
    """Register (or overwrite) a realization under ``spec.name``."""
    _REGISTRY[spec.name] = spec
    return spec


def register_kernel_policy(policy: KernelPolicy) -> KernelPolicy:
    _KERNEL_POLICIES[policy.name] = policy
    return policy


def get_method(name: str) -> MethodSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; expected one of {available_methods()}"
        ) from None


def available_methods() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def kernel_smem_budget(policy: str = "mht_panel") -> int:
    pol = _KERNEL_POLICIES.get(policy)
    return pol.smem_budget if pol is not None else DEFAULT_SMEM_BUDGET


register_kernel_policy(KernelPolicy("macro_ops", DEFAULT_SMEM_BUDGET))


# ---------------------------------------------------------------------------
# sign fixing
# ---------------------------------------------------------------------------

def _signs(r: Tensor, size: int) -> Tensor:
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    s = torch.where(d >= 0, 1.0, -1.0).to(r.dtype)
    if size > s.shape[-1]:
        s = torch.cat([s, s.new_ones(s.shape[:-1] + (size - s.shape[-1],))],
                      dim=-1)
    return s


def sign_fix_qr(q: Tensor, r: Tensor) -> Tuple[Tensor, Tensor]:
    """Flip Q columns / R rows so diag(R) >= 0 (Q R product unchanged);
    leading batch dimensions are element-wise."""
    return (q * _signs(r, q.shape[-1])[..., None, :],
            r * _signs(r, r.shape[-2])[..., :, None])


def sign_fix_r(r: Tensor) -> Tensor:
    return r * _signs(r, r.shape[-2])[..., :, None]


# ---------------------------------------------------------------------------
# degenerate (zero-dim) shapes
# ---------------------------------------------------------------------------

def _solve_degenerate(a: Tensor, cfg: QRConfig):
    """QR of an empty matrix with ``torch.linalg.qr`` semantics."""
    m, n = a.shape
    k = min(m, n)
    kw = dict(dtype=a.dtype, device=a.device)
    if cfg.mode == "r":
        return torch.zeros((k, n), **kw)
    if cfg.mode == "reduced":
        return torch.eye(m, k, **kw), torch.zeros((k, n), **kw)
    return torch.eye(m, **kw), torch.zeros((m, n), **kw)


register_method(MethodSpec(
    name="degenerate",
    solve=_solve_degenerate,
    description="trivial zero-dim (m == 0 or n == 0) factorization with "
                "torch.linalg.qr semantics — the planner's early-return "
                "for empty matrices",
))


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def _require_kernel_fits(spec: MethodSpec, m: int, n: int, cfg: QRConfig,
                         dtype) -> None:
    """Raise when ``spec``'s kernels do not fit their shared-memory budget."""
    dtype = as_torch_dtype(cfg.precision or dtype)
    need = spec.smem_bytes(m, n, cfg, dtype.itemsize)
    budget = kernel_smem_budget(spec.kernel_policy)
    if need > budget:
        raise ValueError(
            f"method {spec.name!r} at block {cfg.block} in {dtype}: the "
            f"kernels' per-task shared memory ({need} B) exceeds the budget "
            f"({budget} B); shrink config.block, or pass use_kernel=False "
            f"for the plain lowering")


# Canonical auto-routing rule order (the reference's): an auto plan's
# non-fallback decisions are the prefix of this sequence ending at the
# selected rule.
_ROUTE_RULES = ("degenerate_empty", "explicit", "tuned", "tsqr_tall_skinny",
                "tiled_near_square", "sharded_past_ceiling",
                "tpu_kernel_panel_fits", "single_panel", "blocked_default")


# The "decide for me" defaults the tuned overlay respects: a measured
# config only overrides knobs the caller left untouched.
_DEFAULT_CONFIG = QRConfig()


def tuned_dispatch_mode(entry) -> Optional[str]:
    """The dispatch mode a measured entry decides for every member of its
    shape class: its best pick's mode when the entry timed both kernel
    lowerings at that block, else None (the engine's budget rule decides
    for each member's own grid; ROADMAP C7).  A class is measured at its
    edge, where the megakernel may be over budget while a smaller
    member's grid fits it (640^2 in the 768^2 class)."""
    best = entry.best
    timed = entry.timings_dict
    if best.use_kernel and best.dispatch_mode is not None and all(
            f"tiled[b{best.block},{mode}]" in timed
            for mode in ("wavefront", "megakernel")):
        return best.dispatch_mode
    return None


def _apply_tuned_config(resolved: QRConfig, requested: QRConfig, entry,
                        decisions: List[RouteDecision]) -> QRConfig:
    """Overlay the measured best config onto the knobs the caller left at
    their defaults — explicit knobs always win over the cache.  Records a
    ``tuned_config`` resolve decision when anything changed, or when the
    entry's dispatch mode was left to the engine's budget rule."""
    best = entry.best
    applied = []
    if (requested.block == _DEFAULT_CONFIG.block
            and best.block != resolved.block):
        resolved = dataclasses.replace(resolved, block=best.block)
        applied.append(f"block={best.block}")
    left = None
    if (requested.dispatch_mode is None and resolved.use_kernel
            and best.dispatch_mode is not None
            and best.dispatch_mode != resolved.dispatch_mode):
        mode = tuned_dispatch_mode(entry)
        if mode is not None:
            resolved = dataclasses.replace(resolved, dispatch_mode=mode)
            applied.append(f"dispatch_mode={mode}")
        else:
            left = (f"dispatch_mode={best.dispatch_mode} not applied: the "
                    f"entry did not measure both lowerings at block "
                    f"{best.block} (its class edge "
                    f"{entry.shape_class[0]}x{entry.shape_class[1]} need "
                    f"not be this grid) — the engine's budget rule decides")
    if (requested.q_method == _DEFAULT_CONFIG.q_method
            and best.q_method != resolved.q_method):
        resolved = dataclasses.replace(resolved, q_method=best.q_method)
        applied.append(f"q_method={best.q_method}")
    if requested.use_kernel is None and resolved.use_kernel:
        applied.append("use_kernel=True")
    if applied or left:
        why = ("measured config applied: " + ", ".join(applied)
               if applied else "")
        decisions.append(RouteDecision(
            "tuned_config", "resolved",
            "; ".join(x for x in (why, left) if x)))
    return resolved


def default_use_kernel(method: str, backend: str) -> bool:
    """``use_kernel=None`` as :func:`plan` resolves it with no measured
    entry: on the card a method whose kernels are ported runs them (or
    the plan raises); elsewhere the plain lowering runs."""
    spec = get_method(method)
    return (backend == "cuda" and spec.kernel_backed
            and spec.smem_bytes is not None)


def _tuned_lookup(m: int, n: int, dtype, config: QRConfig, backend: str,
                  batched: bool):
    """Consult the measured tuning cache: ``(decision, entry-or-None)``.

    A hit must also pass the capability guards the selected method will
    face in :func:`plan` (mode, batched, aspect, and ``use_kernel=True``,
    ROADMAP C3; on the card a kernel-backed pick measured on its plain
    lowering, which :func:`plan` would not run there unasked) — an
    incompatible measured pick records a rejected decision and routing
    falls through."""
    if not config.use_tuning_cache:
        return RouteDecision(
            "tuned", "rejected",
            "use_tuning_cache=False pins the heuristic rules"), None
    from repro_torch.tuning import cache as _tcache

    cache = _tcache.active_cache()
    if len(cache) == 0:
        return RouteDecision(
            "tuned", "rejected",
            f"no tuning cache loaded (source: {cache.source}) — "
            f"heuristic rules apply"), None
    cls = _tcache.shape_class(m, n)
    dt = _tcache.dtype_name(dtype)
    entry = cache.lookup(backend=backend, m=m, n=n, dtype=dtype)
    if entry is None:
        return RouteDecision(
            "tuned", "rejected",
            f"cache miss: no measured entry for shape-class "
            f"{cls[0]}x{cls[1]} ({backend}, {dt}) — "
            f"heuristic rules apply"), None
    best = entry.best
    spec = _REGISTRY.get(best.method)
    why_unfit = (
        f"tuned pick {best.method!r} is not registered" if spec is None else
        f"tuned pick {best.method!r} is thin-only vs mode='full'"
        if config.mode == "full" and not spec.supports_full_q else
        f"tuned pick {best.method!r} does not support batched inputs"
        if batched and not spec.batched else
        f"tuned pick {best.method!r} needs m >= {spec.min_aspect:g}n"
        if spec.min_aspect > 0 and m < spec.min_aspect * n else
        f"tuned pick {best.method!r} has no kernel-backed realization "
        f"vs use_kernel=True"
        if config.use_kernel and not spec.kernel_backed else
        f"tuned pick {best.method!r} was measured on its plain lowering; "
        f"on the card its kernels run unless use_kernel=False"
        if (config.use_kernel is None and not best.use_kernel
            and default_use_kernel(best.method, backend)) else None)
    if why_unfit is not None:
        return RouteDecision("tuned", "rejected", why_unfit), None
    knobs = f"block={best.block}"
    if best.use_kernel:
        knobs += f", dispatch={best.dispatch_mode}"
    return RouteDecision(
        "tuned", "selected",
        f"measured: {best.method}[{knobs}] {entry.best_us:.0f} us vs "
        f"heuristic {entry.heuristic_method} {entry.heuristic_us:.0f} us "
        f"on {entry.backend}/{entry.device_kind} shape-class "
        f"{cls[0]}x{cls[1]} ({entry.dtype})"), entry


def _opted_in(config: QRConfig) -> bool:
    """Does the caller ask for a solve across ranks?  ``ndomains > 1``
    (``method="sharded_tiled"`` bypasses the auto route)."""
    return config.ndomains is not None and config.ndomains > 1


def _default_ndevices(config: QRConfig) -> int:
    """The ranks the auto route may shard a solve over: the default
    process group's size when the caller opts in (:func:`_opted_in`),
    else 1.  The reference counts ``jax.local_device_count()``, the
    devices of one process; a rank's own ``qr`` on a group stays a local
    solve unless asked (ROADMAP C10).  Cards present but not joined in a
    group never count."""
    from repro_torch.distributed import sharding

    return sharding.world_size() if _opted_in(config) else 1


def _group_ranks() -> int:
    from repro_torch.distributed import sharding

    return sharding.world_size()


def _route(shape, dtype, config: QRConfig, backend: Optional[str],
           ndevices: Optional[int]):
    """The routing table with its reasoning: ``(method, decisions,
    tuned_entry)``; ``tuned_entry`` is the measured cache entry when the
    ``"tuned"`` rule won, else None."""
    _ensure_builtins()
    dec: List[RouteDecision] = []
    m, n = int(shape[-2]), int(shape[-1])

    if min(m, n) == 0:
        why = (f"zero-dim input {m}x{n} — trivial factorization with "
               f"jnp.linalg.qr semantics")
        if config.method not in ("auto", "degenerate"):
            why += (f" (overrides config.method={config.method!r}: no "
                    f"backend factors an empty matrix)")
        dec.append(RouteDecision("degenerate_empty", "selected", why))
        return "degenerate", dec, None
    if config.method != "auto":
        dec.append(RouteDecision(
            "explicit", "selected",
            f"config.method={config.method!r} bypasses auto routing"))
        return config.method, dec, None
    backend = "cuda" if backend is None else backend
    ndevices = _default_ndevices(config) if ndevices is None else int(ndevices)
    aspect = m / n if n else float("inf")

    tuned_dec, tuned = _tuned_lookup(m, n, dtype, config, backend,
                                     batched=len(shape) > 2)
    dec.append(tuned_dec)
    if tuned is not None:
        return tuned.best.method, dec, tuned

    tspec = _REGISTRY.get("tsqr")
    if (tspec is not None and config.mode != "full" and n >= 1 and m >= 8
            and m >= tspec.min_aspect * n):
        dec.append(RouteDecision(
            "tsqr_tall_skinny", "selected",
            f"aspect {aspect:.2f} >= {tspec.min_aspect:g} "
            f"({m}x{n}, mode={config.mode!r})"))
        return "tsqr", dec, None
    if tspec is not None:
        dec.append(RouteDecision(
            "tsqr_tall_skinny", "rejected",
            f"mode='full' needs full Q (tsqr is thin-only)"
            if config.mode == "full" else
            f"aspect {aspect:.2f} < {tspec.min_aspect:g} (or m={m} < 8)"))

    tiled_floor = _TILED_MIN_DIM_CPU if backend == "cpu" else _TILED_MIN_DIM
    near_square = (min(m, n) >= tiled_floor
                   and max(m, n) < _TILED_MAX_ASPECT * min(m, n))
    if (backend == "cpu" and "tiled" in _REGISTRY
            and _TILED_MIN_DIM <= min(m, n) < _TILED_MIN_DIM_CPU
            and max(m, n) < _TILED_MAX_ASPECT * min(m, n)
            and max(m, n) <= _TILED_MAX_DIM):
        dec.append(RouteDecision(
            "tiled_min_dim_cpu_floor", "fallback",
            f"min dim {min(m, n)} >= {_TILED_MIN_DIM} routes tiled "
            f"off-CPU, but < CPU floor {_TILED_MIN_DIM_CPU} (measured "
            f"LAPACK geqrf crossover) — falling through to blocked"))
    if "tiled" in _REGISTRY and near_square and max(m, n) <= _TILED_MAX_DIM:
        dec.append(RouteDecision(
            "tiled_near_square", "selected",
            f"min dim {min(m, n)} >= floor {tiled_floor} "
            f"({backend}), aspect {max(m, n) / min(m, n):.2f} < "
            f"{_TILED_MAX_ASPECT:g}, max dim {max(m, n)} <= "
            f"{_TILED_MAX_DIM}"))
        return "tiled", dec, None
    if "tiled" in _REGISTRY:
        dec.append(RouteDecision(
            "tiled_near_square", "rejected",
            f"min dim {min(m, n)} < floor {tiled_floor} ({backend})"
            if min(m, n) < tiled_floor else
            f"aspect {max(m, n) / min(m, n):.2f} >= {_TILED_MAX_ASPECT:g}"
            if max(m, n) >= _TILED_MAX_ASPECT * min(m, n) else
            f"max dim {max(m, n)} > single-device ceiling {_TILED_MAX_DIM}"))

    sharded_ceiling = _TILED_MAX_DIM * min(ndevices, _SHARDED_MAX_DOM_FACTOR)
    if ("sharded_tiled" in _REGISTRY and near_square and config.mode != "full"
            and len(shape) == 2 and m >= n and ndevices > 1
            and max(m, n) <= sharded_ceiling):
        dec.append(RouteDecision(
            "sharded_past_ceiling", "selected",
            f"near-square {m}x{n} <= sharded ceiling {sharded_ceiling} "
            f"({ndevices} devices x {_TILED_MAX_DIM})"))
        return "sharded_tiled", dec, None
    if "sharded_tiled" in _REGISTRY:
        dec.append(RouteDecision(
            "sharded_past_ceiling", "rejected",
            f"not near-square at floor {tiled_floor} (min dim "
            f"{min(m, n)}, aspect {max(m, n) / min(m, n):.2f})"
            if not near_square else
            "batched input (no shard_map under vmap)"
            if len(shape) != 2 else
            "mode='full' needs full Q (sharded merge is thin-only)"
            if config.mode == "full" else
            f"wide matrix ({m}x{n}): row-domain sharding needs m >= n"
            if m < n else
            f"single device available (ndevices={ndevices}); the "
            f"{_group_ranks()} ranks of the process group count only "
            f"with an opt-in: QRConfig(ndomains=k > 1) or "
            f"method='sharded_tiled'"
            if ndevices <= 1 and _group_ranks() > 1 else
            f"single device available (ndevices={ndevices})"
            if ndevices <= 1 else
            f"max dim {max(m, n)} > sharded ceiling {sharded_ceiling}"
            if max(m, n) > sharded_ceiling else
            f"max dim {max(m, n)} <= single-device tiled ceiling "
            f"{_TILED_MAX_DIM} — tiled declined for its own reason"))

    if "geqrf_ht" in _REGISTRY:
        # The reference's TPU panel-kernel rule; never fires off a TPU.
        dec.append(RouteDecision(
            "tpu_kernel_panel_fits", "rejected",
            f"backend={backend} is not tpu"))
    if min(m, n) <= config.block:
        dec.append(RouteDecision(
            "single_panel", "selected",
            f"min dim {min(m, n)} <= block {config.block} — one "
            f"unblocked panel (geqr2_ht)"))
        return "geqr2_ht", dec, None
    dec.append(RouteDecision(
        "single_panel", "rejected",
        f"min dim {min(m, n)} > block {config.block} — needs blocking"))
    dec.append(RouteDecision(
        "blocked_default", "selected",
        f"no specialized rule matched {m}x{n} on {backend} — blocked "
        f"geqrf_ht default"))
    return "geqrf_ht", dec, None


def select_method(shape, dtype, config: QRConfig, *,
                  backend: Optional[str] = None,
                  ndevices: Optional[int] = None) -> str:
    """The ``method="auto"`` routing table (trailing two dims of shape);
    a pure query.  See :func:`plan` and the reference's docstring for the
    rules."""
    _check_backend(backend)
    return _route(shape, dtype, config, backend, ndevices)[0]


def _check_backend(backend: Optional[str]) -> None:
    if backend is not None and backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{_BACKENDS}")


def plan(shape, dtype=torch.float32, config: Optional[QRConfig] = None, *,
         backend: Optional[str] = None,
         ndevices: Optional[int] = None,
         explain: bool = False) -> "QRSolver":
    """Resolve ``(shape, dtype, config)`` to a concrete :class:`QRSolver`.

    ``backend`` ("cuda" or "cpu") is the device the solve will run on;
    None means "cuda", the entry points' default.  ``ndevices`` overrides
    the device count of the sharded routing rule.  ``explain=True``
    attaches the :class:`PlanExplain` decision trail.  Every plan adds to
    ``planner.plans{method}`` and each fallback decision to
    ``planner.fallbacks{reason}``, with or without ``explain``.
    """
    _ensure_builtins()
    _check_backend(backend)
    cfg = QRConfig() if config is None else config
    if len(shape) < 2:
        raise ValueError(f"qr plan expects a matrix shape, got {tuple(shape)}")
    m, n = int(shape[-2]), int(shape[-1])
    batched = len(shape) > 2
    backend = "cuda" if backend is None else backend
    dtype = as_torch_dtype(dtype)

    name, decisions, tuned = _route(shape, dtype, cfg, backend, ndevices)
    # Fallbacks of the routing table count here, once per plan: _route is
    # a pure query.  Resolve hooks count the fallbacks they append.
    for d in decisions:
        if d.outcome == "fallback":
            _metrics.counter("planner.fallbacks", reason=d.rule).inc()
    spec = get_method(name)
    if name == "degenerate" and min(m, n) > 0:
        raise ValueError(
            f"method 'degenerate' handles zero-dim shapes only "
            f"(m == 0 or n == 0), got {m}x{n}")
    if batched and not spec.batched:
        raise ValueError(f"method {name!r} does not support batched inputs")
    if cfg.mode == "full" and not spec.supports_full_q:
        raise ValueError(f"method {name!r} produces thin Q only")
    if spec.min_aspect > 0 and m < spec.min_aspect * n:
        raise ValueError(
            f"method {name!r} expects tall-skinny input "
            f"(m >= {spec.min_aspect:g}n, got {m}x{n})")

    use_kernel = cfg.use_kernel
    if use_kernel is None:
        if tuned is not None:
            # The lowering the sweep measured for this class (on the
            # card a kernel-backed pick measured plain was rejected).
            use_kernel = bool(tuned.best.use_kernel) and spec.kernel_backed
        else:
            use_kernel = default_use_kernel(name, backend)
    elif use_kernel and not spec.kernel_backed:
        raise ValueError(f"method {name!r} has no kernel-backed realization")

    resolved = dataclasses.replace(cfg, method=name, use_kernel=bool(use_kernel))
    if tuned is not None:
        resolved = _apply_tuned_config(resolved, cfg, tuned, decisions)
    if cfg.use_kernel is None and resolved.use_kernel \
            and spec.smem_bytes is not None:
        _require_kernel_fits(spec, m, n, resolved, dtype)
    if spec.resolve is not None:
        resolved = spec.resolve(m, n, resolved, dtype=dtype, explain=decisions)
    _metrics.counter("planner.plans", method=name).inc()
    record = None
    if explain:
        record = PlanExplain(
            shape=(m, n), dtype=str(dtype).replace("torch.", ""),
            backend=backend,
            ndevices=(_default_ndevices(cfg) if ndevices is None
                      else int(ndevices)),
            requested_method=cfg.method, method=name,
            use_kernel=bool(use_kernel),
            dispatch_mode=resolved.dispatch_mode,
            decisions=tuple(decisions),
            fallback_reasons=tuple(d.rule for d in decisions
                                   if d.outcome == "fallback"))
    return QRSolver(shape=(m, n), dtype=dtype, config=resolved, spec=spec,
                    explain=record)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

def _apply_q(packed: Tensor, taus: Tensor, c: Tensor, cfg: QRConfig, *,
             transpose: bool = False) -> Tensor:
    """Q (or Q^T) of a packed factorization applied to ``c``: panel by
    panel through the trailing kernel on the kernel path, one reflector at
    a time (the reference's ``apply_q``) on the plain lowering."""
    from repro_torch.core import blocked, householder

    if cfg.use_kernel:
        return blocked.apply_q_blocked(packed, taus, c, block=cfg.block,
                                       transpose=transpose, use_kernel=True)
    return householder.apply_q(packed, taus, c, transpose=transpose)


def _form_q(packed: Tensor, taus: Tensor, cfg: QRConfig, *,
            full: bool = False) -> Tensor:
    from repro_torch.core import blocked, householder

    if cfg.use_kernel:
        return blocked.form_q_blocked(packed, taus, block=cfg.block,
                                      full=full, use_kernel=True)
    return householder.form_q(packed, taus, full=full)


def _default_solve(spec: MethodSpec, a: Tensor, cfg: QRConfig):
    """Per-mode output of a ``(B, m, n)`` stack from the method's packed
    ``factor`` — the reference's ``_default_solve``, a stack at a time:
    R from the packed upper triangle; Q formed from the reflectors, or
    ``A R^{-1}`` for ``q_method="solve"``; ``mode="full"`` pads R with
    zero rows."""
    from repro_torch.core import householder

    m, n = a.shape[-2:]
    k = min(m, n)
    packed, taus = spec.factor(a, cfg)
    r = householder.unpack_r(packed, n)
    if cfg.mode == "r":
        return sign_fix_r(r) if cfg.sign_fix else r
    if cfg.mode == "reduced":
        if cfg.q_method == "solve" and m >= n:
            from repro_torch.core.tsqr import triangular_inverse_apply

            q = triangular_inverse_apply(a, r[..., :n, :n])
        else:
            q = _form_q(packed, taus, cfg)
        return sign_fix_qr(q, r) if cfg.sign_fix else (q, r)
    q = _form_q(packed, taus, cfg, full=True)
    if m > k:
        r = torch.cat([r, r.new_zeros(r.shape[:-2] + (m - k, n))], dim=-2)
    return sign_fix_qr(q, r) if cfg.sign_fix else (q, r)


@dataclasses.dataclass(frozen=True)
class QRSolver:
    """A planned QR factorization for one matrix shape.  It runs on the
    device of the tensor it is given."""

    shape: Tuple[int, int]
    dtype: torch.dtype
    config: QRConfig
    spec: MethodSpec
    explain: Optional[PlanExplain] = dataclasses.field(default=None,
                                                       compare=False)

    def _check(self, a: Tensor) -> None:
        if a.ndim < 2 or tuple(a.shape[-2:]) != self.shape:
            raise ValueError(
                f"solver planned for {self.shape}, got input shape "
                f"{tuple(a.shape)}")
        if a.dtype != self.dtype:
            raise ValueError(
                f"solver planned for dtype {self.dtype}, got {a.dtype}; "
                "re-plan or cast (kernel decisions are dtype-dependent)")
        if a.ndim > 2 and not self.spec.batched:
            raise ValueError(f"method {self.config.method!r} does not "
                             f"support batched inputs")

    def _cast(self, a: Tensor) -> Tensor:
        if self.config.precision is not None:
            return a.to(as_torch_dtype(self.config.precision))
        return a

    def _solve2d(self, a: Tensor):
        if self.spec.solve is None:
            out = _default_solve(self.spec, self._cast(a)[None], self.config)
            return out[0] if self.config.mode == "r" else tuple(x[0] for x in out)
        return self.spec.solve(self._cast(a), self.config)

    def solve(self, a: Tensor):
        """Factorize per ``config.mode``: (Q, R), R only, or full (Q, R).
        Leading batch dims go to the method as one stack of all the
        matrices — to its ``solve_batched``, or through its packed
        ``factor`` — or are solved matrix by matrix when it has neither."""
        self._check(a)
        if a.ndim == 2:
            return self._solve2d(a)
        lead = tuple(a.shape[:-2])
        # The leading dims' product, not -1: a stack of empty matrices has
        # no elements to infer it from.
        stack = a.reshape((math.prod(lead),) + self.shape)
        if self.spec.solve_batched is not None:
            out = self.spec.solve_batched(self._cast(stack), self.config)
        elif self.spec.solve is None:
            out = _default_solve(self.spec, self._cast(stack), self.config)
        else:
            outs = [self._solve2d(x) for x in stack]
            out = (tuple(torch.stack(xs) for xs in zip(*outs))
                   if isinstance(outs[0], tuple) else torch.stack(outs))
        if isinstance(out, tuple):
            return tuple(x.reshape(lead + x.shape[1:]) for x in out)
        return out.reshape(lead + out.shape[1:])

    def factor(self, a: Tensor) -> Tuple[Tensor, Tensor]:
        """LAPACK packed form ``(packed, taus)`` of ``a`` (methods that
        have one); leading batch dims are factored as one stack."""
        if self.spec.factor is None:
            raise ValueError(
                f"method {self.config.method!r} has no packed factored form")
        self._check(a)
        lead = tuple(a.shape[:-2])
        packed, taus = self.spec.factor(
            self._cast(a.reshape((math.prod(lead),) + self.shape)),
            self.config)
        return (packed.reshape(lead + packed.shape[1:]),
                taus.reshape(lead + taus.shape[1:]))

    def orthogonalize(self, a: Tensor) -> Tensor:
        """Sign-fixed thin Q (the optimizer primitive) of tall input."""
        solver = self if (self.config.sign_fix and self.config.mode == "reduced") \
            else dataclasses.replace(
                self, config=self.config.replace(sign_fix=True, mode="reduced"))
        q, _ = solver.solve(a)
        return q

    def lstsq(self, a: Tensor, b: Tensor) -> Tensor:
        """Least-squares solve ``min ||a x - b||`` via this realization."""
        m, n = self.shape
        if m < n:
            raise ValueError("lstsq expects m >= n")
        if a.ndim != 2:
            raise ValueError("lstsq expects a single matrix")
        b2 = b if b.ndim == 2 else b[:, None]
        if self.spec.factor is not None:
            from repro_torch.core import householder

            packed, taus = self.factor(a)
            qtb = _apply_q(packed, taus, b2.to(packed.dtype), self.config,
                           transpose=True)
            r = householder.unpack_r(packed, n)[:n, :n]
            x = torch.linalg.solve_triangular(r, qtb[:n], upper=True)
        else:
            cfg = self.config.replace(mode="reduced", sign_fix=False)
            q, r = dataclasses.replace(self, config=cfg).solve(a)
            x = torch.linalg.solve_triangular(r[:n, :n], q.T @ b2.to(q.dtype),
                                              upper=True)
        return x[:, 0] if b.ndim == 1 else x
