"""repro_torch.tuning — the measured half of the planner's routing.

``sweep`` times candidate ``(method, block, dispatch_mode)`` configs per
shape class on the device; ``cache`` persists the results as the
versioned JSON (the reference's schema) that the planner's ``"tuned"``
routing rule consults before its static heuristics.  Sweep the card
with::

    PYTHONPATH=src python -m repro_torch.tuning.sweep --out cache.json --check

and install the result with ``set_active_cache(TuningCache.load(path))``
or ``$REPRO_TORCH_TUNING_CACHE``.
"""

from repro_torch.tuning.cache import (  # noqa: F401
    DEFAULT_CACHE_PATH,
    ENV_VAR,
    SCHEMA,
    TunedConfig,
    TuningCache,
    TuningEntry,
    active_cache,
    active_cache_info,
    set_active_cache,
    shape_class,
)

__all__ = [
    "DEFAULT_CACHE_PATH",
    "ENV_VAR",
    "SCHEMA",
    "TunedConfig",
    "TuningCache",
    "TuningEntry",
    "active_cache",
    "active_cache_info",
    "set_active_cache",
    "shape_class",
]
