"""repro_torch.tuning.cache — versioned on-disk cache of measured planner
configs.

Counterpart of the reference's ``repro.tuning.cache``, with the same
schema (``qr-tuning-v1``), so either package reads the JSON the other
writes.  The planner's ``method="auto"`` heuristics are static guesses
(the tiled floor, aspect cutoffs); this is the measured half: a JSON
cache mapping ``(backend, device_kind, shape_class, dtype)`` to the best
``(method, block, dispatch_mode, q_method, use_kernel)`` configuration
:mod:`repro_torch.tuning.sweep` timed on the actual device, plus every
candidate's wall time and the heuristic pick it displaced — so a
``"tuned"`` :class:`repro_torch.core.plan.RouteDecision` cites measured
microseconds instead of a threshold.

Shape classes reuse the serving layer's pow2-ish bucket edges
(:func:`repro_torch.serving.bucketing.pad_dim`): two shapes that would
share a serving bucket share a tuning entry.

The **active cache** is what :func:`repro_torch.core.plan.plan`
consults.  It loads lazily, once per process, from
``$REPRO_TORCH_TUNING_CACHE`` when set — its own variable, so a cache
set for the reference never routes the port — else from
``default_cuda.json`` next to this module.  A missing file means an
empty cache: every lookup records a rejected ``tuned`` decision and
routing falls through to the heuristics.  Tests install their own via
:func:`set_active_cache` and restore with the returned previous value.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "SCHEMA",
    "ENV_VAR",
    "DEFAULT_CACHE_PATH",
    "TunedConfig",
    "TuningEntry",
    "TuningCache",
    "shape_class",
    "active_cache",
    "active_cache_info",
    "set_active_cache",
    "dtype_name",
]

SCHEMA = "qr-tuning-v1"

#: Environment variable naming a cache file that overrides the default
#: (how a user points the port's planner at a fresh sweep).
ENV_VAR = "REPRO_TORCH_TUNING_CACHE"

#: The default cache of the card, written by
#: ``python -m repro_torch.tuning.sweep --out src/repro_torch/tuning/default_cuda.json``.
DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__),
                                  "default_cuda.json")

# Shape-class granularity: the serving layer's default bucketing policy
# (tile 32, 25% waste cap) — see repro_torch.serving.bucketing.
_CLASS_TILE = 32
_CLASS_MAX_WASTE = 0.25


def dtype_name(dtype) -> str:
    """The cache's dtype key (``"float32"``) of a torch or numpy dtype or
    a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def shape_class(m: int, n: int, *, tile: int = _CLASS_TILE,
                max_waste: float = _CLASS_MAX_WASTE) -> Tuple[int, int]:
    """The ``(m, n)`` shape class a matrix tunes/looks up under — the
    serving layer's pow2-ish bucket edges, so tuning classes and serving
    buckets coincide."""
    from repro_torch.serving.bucketing import pad_dim

    if m < 1 or n < 1:
        raise ValueError(
            f"shape_class needs a nonempty matrix, got {m}x{n} (zero-dim "
            "shapes route to the planner's 'degenerate' method)")
    return (pad_dim(m, tile=tile, max_waste=max_waste),
            pad_dim(n, tile=tile, max_waste=max_waste))


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """The planner-facing knobs one sweep candidate pins down."""

    method: str
    block: int = 32
    dispatch_mode: Optional[str] = None
    q_method: str = "formq"
    use_kernel: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        return cls(method=d["method"], block=int(d.get("block", 32)),
                   dispatch_mode=d.get("dispatch_mode"),
                   q_method=d.get("q_method", "formq"),
                   use_kernel=bool(d.get("use_kernel", False)))


@dataclasses.dataclass(frozen=True)
class TuningEntry:
    """One measured shape class: the winning config, the heuristic pick it
    is compared against, and every candidate's wall time (label -> us)."""

    backend: str
    device_kind: str
    shape_class: Tuple[int, int]
    dtype: str
    best: TunedConfig
    best_us: float
    heuristic_method: str
    heuristic_us: float
    timings: Tuple[Tuple[str, float], ...] = ()
    provenance: Tuple[Tuple[str, str], ...] = ()

    @property
    def key(self) -> Tuple[str, int, int, str]:
        return (self.backend, *self.shape_class, self.dtype)

    @property
    def timings_dict(self) -> Dict[str, float]:
        return dict(self.timings)

    @property
    def provenance_dict(self) -> Dict[str, str]:
        return dict(self.provenance)

    def to_dict(self) -> dict:
        return dict(
            backend=self.backend, device_kind=self.device_kind,
            shape_class=list(self.shape_class), dtype=self.dtype,
            best=self.best.to_dict(), best_us=self.best_us,
            heuristic_method=self.heuristic_method,
            heuristic_us=self.heuristic_us,
            timings={k: v for k, v in self.timings},
            provenance={k: v for k, v in self.provenance},
        )

    @classmethod
    def from_dict(cls, d: dict) -> "TuningEntry":
        return cls(
            backend=d["backend"], device_kind=d["device_kind"],
            shape_class=tuple(int(x) for x in d["shape_class"]),
            dtype=d["dtype"], best=TunedConfig.from_dict(d["best"]),
            best_us=float(d["best_us"]),
            heuristic_method=d["heuristic_method"],
            heuristic_us=float(d["heuristic_us"]),
            timings=tuple(sorted((str(k), float(v))
                                 for k, v in d.get("timings", {}).items())),
            provenance=tuple(sorted((str(k), str(v))
                             for k, v in d.get("provenance", {}).items())),
        )


class TuningCache:
    """A set of :class:`TuningEntry` keyed by (backend, shape_class, dtype),
    with JSON (de)serialization and the planner-facing lookup."""

    def __init__(self, entries: Iterable[TuningEntry] = (),
                 source: str = "memory"):
        self.source = source
        self._by_key: Dict[Tuple, List[TuningEntry]] = {}
        for e in entries:
            self.add(e)

    def add(self, entry: TuningEntry) -> None:
        """Insert ``entry``, replacing any same-key same-device_kind one."""
        row = self._by_key.setdefault(entry.key, [])
        row[:] = [e for e in row if e.device_kind != entry.device_kind]
        row.append(entry)

    def entries(self) -> Tuple[TuningEntry, ...]:
        return tuple(e for row in self._by_key.values() for e in row)

    def __len__(self) -> int:
        return sum(len(row) for row in self._by_key.values())

    def lookup(self, *, backend: str, m: int, n: int, dtype,
               device_kind: Optional[str] = None) -> Optional[TuningEntry]:
        """The measured entry governing an ``(m, n)`` plan on ``backend``
        (exact ``device_kind`` match preferred; any same-backend entry
        otherwise), or None — a cache miss the planner records and falls
        through to its heuristics on."""
        if m < 1 or n < 1:
            return None
        key = (backend, *shape_class(m, n), dtype_name(dtype))
        row = self._by_key.get(key)
        if not row:
            return None
        if device_kind is not None:
            for e in row:
                if e.device_kind == device_kind:
                    return e
        return row[0]

    def merge(self, other: "TuningCache") -> None:
        for e in other.entries():
            self.add(e)

    # -- serialization -----------------------------------------------------

    def to_json(self) -> dict:
        return dict(schema=SCHEMA,
                    entries=[e.to_dict() for e in self.entries()])

    @classmethod
    def from_json(cls, doc: dict, source: str = "memory") -> "TuningCache":
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"tuning cache schema {doc.get('schema')!r} != {SCHEMA!r} "
                f"(regenerate with python -m repro_torch.tuning.sweep)")
        return cls((TuningEntry.from_dict(d) for d in doc.get("entries", ())),
                   source=source)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as f:
            return cls.from_json(json.load(f), source=path)


# ---------------------------------------------------------------------------
# the active cache (what plan() consults)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_active: Optional[TuningCache] = None
_loaded = False


def _load_default() -> TuningCache:
    path = os.environ.get(ENV_VAR) or DEFAULT_CACHE_PATH
    try:
        return TuningCache.load(path)
    except FileNotFoundError:
        if os.environ.get(ENV_VAR):
            warnings.warn(f"{ENV_VAR}={path} does not exist; "
                          "planner falls back to heuristics")
        return TuningCache(source=f"missing:{path}")
    except (ValueError, json.JSONDecodeError, OSError) as e:
        warnings.warn(f"tuning cache {path} unreadable ({e}); "
                      "planner falls back to heuristics")
        return TuningCache(source=f"unreadable:{path}")


def active_cache() -> TuningCache:
    """The process-wide cache ``plan()`` consults (lazily loaded once)."""
    global _active, _loaded
    with _lock:
        if not _loaded:
            _active = _load_default()
            _loaded = True
        return _active


def set_active_cache(cache: Optional[TuningCache]
                     ) -> Optional[TuningCache]:
    """Install ``cache`` as the active cache, returning the previous one
    (restore with another call).  ``None`` reverts to lazy default
    loading on the next :func:`active_cache` call."""
    global _active, _loaded
    with _lock:
        prev = _active if _loaded else None
        _active = cache
        _loaded = cache is not None
        return prev


def active_cache_info() -> dict:
    """Provenance summary of the active cache: what the QR service's plan
    fingerprint and a run's artifacts record."""
    c = active_cache()
    return dict(
        schema=SCHEMA, source=c.source, entries=len(c),
        classes=sorted(f"{e.backend}:{e.shape_class[0]}x{e.shape_class[1]}:"
                       f"{e.dtype}" for e in c.entries()),
    )
