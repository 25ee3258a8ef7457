"""Shape bucketing for the QR serving layer.

Counterpart of the reference's ``repro.serving.bucketing``, copied: it is
pure Python, and the port keeps its policy as it is.

Production QR traffic is thousands of concurrent heterogeneous
``(m, n, dtype, mode)`` requests; the engine wants few, large, statically
shaped dispatches.  This module maps each request to a **bucket** — a
padded shape class — so requests sharing a bucket can be zero-padded,
stacked, and factored in one batched dispatch
(:func:`repro_torch.core.engine.factor_tiles_batched`).  Zero padding is
numerically free for QR: padded rows/columns factor to exactly-zero
reflector entries, so the unpadded ``Q``/``R`` slices of the padded
factorization ARE the factorization of the original matrix (the same
invariant ``tiled_qr`` already relies on for non-multiple-of-tile
shapes).

Bucket edges are **pow2-ish** — per dimension, the candidate edges are
``tile * 2^k`` and ``tile * 3 * 2^(k-1)`` (ratio <= 4/3 between
consecutive edges) — so the number of distinct buckets a traffic mix can
produce stays logarithmic in the shape range, which is what keeps the
compiled-plan cache small and steady-state serving compile-free.  A
configurable **waste cap** bounds the padding cost: when the pow2-ish
edge would pad more than ``max_waste`` of the padded extent, the
dimension falls back to the next tile multiple instead (tile granularity
is the floor — every edge must be a tile multiple for the tile-grid
engine).  Batch sizes are padded to pow2 so plan shapes stay finite
there too.

Every request lands in exactly ONE bucket (``bucket_key`` is a pure
function of the request), and the cap is honored whenever it is
achievable at tile granularity — both property-tested in
tests/test_qr_service.py and, on this copy, tests/test_torch_qr_service.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = [
    "BucketKey",
    "BucketingPolicy",
    "bucket_key",
    "bucketize",
    "group_shape_classes",
    "pad_batch",
    "pad_dim",
    "pow2ish_edges",
]


def pow2ish_edges(tile: int, hi: int) -> Tuple[int, ...]:
    """Ascending pow2-ish edge candidates covering ``[tile, >= hi]``:
    ``tile * {1, 2, 3, 4, 6, 8, 12, 16, ...}`` — the multipliers are
    ``2^k`` and ``3 * 2^(k-1)``, so every edge is a tile multiple and
    consecutive ratios are <= 2 (and <= 1.5 from the third edge on)."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    mults: List[int] = [1, 2, 3]
    while tile * mults[-1] < hi:
        mults.append(2 * mults[-2])
    return tuple(tile * c for c in mults)


def pad_dim(d: int, *, tile: int, max_waste: float) -> int:
    """Bucketed extent of one dimension: the smallest pow2-ish edge
    >= ``d``, unless that edge would waste more than ``max_waste`` of the
    padded extent — then the next tile multiple (the finest granularity
    the tile-grid engine admits).  Always a tile multiple >= ``d`` and
    >= ``tile``; monotone in ``d``."""
    if d < 1:
        raise ValueError(f"dimension must be >= 1, got {d}")
    d = max(d, 1)
    for e in pow2ish_edges(tile, d):
        if e >= d:
            break
    tiled_up = -(-d // tile) * tile
    if (e - d) / e > max_waste:
        return tiled_up
    return e


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """How requests map to buckets.

    tile:       engine tile size (``QRConfig.block`` of the bucketed
                plan) — every padded extent is a multiple of it.
    max_waste:  per-dimension padding cap (fraction of the padded
                extent); pow2-ish edges exceeding it fall back to tile
                granularity.  Honored whenever achievable at tile
                granularity (tiny dims floor at one tile).
    max_batch:  largest bucket batch one dispatch may carry; larger
                groups split into max_batch-sized chunks.
    """

    tile: int = 32
    max_waste: float = 0.25
    max_batch: int = 64

    def __post_init__(self):
        if self.tile < 1:
            raise ValueError(f"tile must be >= 1, got {self.tile}")
        if not 0.0 <= self.max_waste < 1.0:
            raise ValueError(
                f"max_waste must be in [0, 1), got {self.max_waste}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """A padded shape class — everything a compiled bucket plan is
    specialized on.  Hashable: the plan-cache key is (BucketKey, batch)."""

    m: int
    n: int
    dtype: str
    mode: str

    def __post_init__(self):
        if self.mode not in ("reduced", "r"):
            raise ValueError(
                f"serving modes are 'reduced' and 'r', got {self.mode!r}")


def bucket_key(m: int, n: int, dtype, mode: str,
               policy: BucketingPolicy) -> BucketKey:
    """The ONE bucket a ``(m, n, dtype, mode)`` request lands in."""
    import numpy as np

    return BucketKey(
        m=pad_dim(m, tile=policy.tile, max_waste=policy.max_waste),
        n=pad_dim(n, tile=policy.tile, max_waste=policy.max_waste),
        dtype=str(np.dtype(dtype)),
        mode=mode,
    )


def pad_batch(b: int, *, max_batch: int) -> int:
    """Padded batch size: next power of two, capped at ``max_batch`` —
    keeps the number of distinct compiled (bucket, batch) plans
    logarithmic in the arrival rate."""
    if b < 1:
        raise ValueError(f"batch must be >= 1, got {b}")
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch)


def group_shape_classes(shapes: Sequence[Tuple], policy: BucketingPolicy,
                        *, mode: str = "reduced"
                        ) -> Dict[BucketKey, List[int]]:
    """Group ``(m, n, dtype)`` shape triples into padded shape classes,
    returning the member indices of each class (input order preserved
    within a class) — the reusable core of request bucketing, shared by
    the serving intake (:func:`bucketize` over request objects) and the
    reference's batched orthogonalization of the optimizer, which groups
    the 2-D momentum matrices of one update step the same way."""
    grouped = bucketize(list(enumerate(shapes)), policy,
                        key_fn=lambda t: (t[1][0], t[1][1], t[1][2], mode))
    return {key: [i for i, _ in members] for key, members in grouped.items()}


def bucketize(requests: Sequence, policy: BucketingPolicy,
              key_fn=None) -> Dict[BucketKey, List]:
    """Group requests by bucket, preserving submission order within each
    bucket.  ``key_fn(req) -> (m, n, dtype, mode)`` defaults to reading
    ``req.shape`` / ``req.dtype`` / ``req.mode`` (QRRequest duck type)."""
    if key_fn is None:
        key_fn = lambda r: (*r.shape, r.dtype, r.mode)  # noqa: E731
    out: Dict[BucketKey, List] = {}
    for req in requests:
        m, n, dtype, mode = key_fn(req)
        out.setdefault(bucket_key(m, n, dtype, mode, policy), []).append(req)
    return out
