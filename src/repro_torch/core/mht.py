"""Modified Householder Transform (MHT) — paper §4, Algorithms 6-8.

Counterpart of the reference's ``repro.core.mht``.  The classical HT
trailing update is two dependent passes, ``w = tau v^T A`` then
``A -= v w``; MHT fuses them into one macro operation per element,

    a_ij <- a_ij - tau * v_i * (v . a_:j)

(paper eq. 12).  Same reflectors, same R, same packed layout as
:func:`repro_torch.core.householder.geqr2`; only the dataflow differs.
On the card ``geqr2_ht`` runs the hand-written ``mht_panel`` kernel
(:mod:`repro_torch.kernels.ops`); the functions here are its plain
realization, batched over leading dimensions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.householder import _write_packed_column, house_vector

__all__ = ["geqr2_ht", "mht_update", "mht_panel_jnp", "geqr2_ht_batched"]

Tensor = torch.Tensor


def mht_update(a: Tensor, v: Tensor, tau: Tensor, col: int) -> Tensor:
    """Fused MHT trailing update ``A <- A - v (tau (v^T A))`` of the
    columns after ``col``; the others are preserved.  Returns a new
    tensor."""
    a = a.clone()
    _mht_update_(a, v, tau, col)
    return a


def _mht_update_(a: Tensor, v: Tensor, tau: Tensor, col: int) -> None:
    trail = a[..., :, col + 1:]
    trail -= v[..., :, None] * (
        tau[..., None] * (v[..., None, :] @ trail)[..., 0, :])[..., None, :]


def geqr2_ht(a: Tensor, *, num_cols: Optional[int] = None
             ) -> Tuple[Tensor, Tensor]:
    """MHT QR factorization (``DGEQR2HT``, paper Algorithm 7): ``k =
    min(m, n)`` (or ``num_cols``) reflectors, every column updated.
    Returns ``(packed, taus)``."""
    m, n = a.shape[-2:]
    k = min(m, n) if num_cols is None else num_cols
    a = a.clone()
    taus = a.new_zeros(a.shape[:-2] + (k,))
    for j in range(k):
        v, tau, beta = house_vector(a[..., :, j], j)
        _mht_update_(a, v, tau, j)
        _write_packed_column(a, v, beta, j)
        taus[..., j] = tau
    return a, taus


def mht_panel_jnp(panel: Tensor) -> Tuple[Tensor, Tensor]:
    """MHT factorization of a whole panel — the reference's name for the
    plain function its panel kernel replaces; here ``geqr2_ht``."""
    return geqr2_ht(panel)


def geqr2_ht_batched(a: Tensor) -> Tuple[Tensor, Tensor]:
    """MHT over a batch of matrices (leading axis); :func:`geqr2_ht`
    already treats leading dimensions as a batch."""
    return geqr2_ht(a)


# -- registry -----------------------------------------------------------------
from repro_torch.core.plan import MethodSpec, QRConfig, register_method  # noqa: E402


def _factor_geqr2_ht(a: Tensor, cfg: QRConfig) -> Tuple[Tensor, Tensor]:
    """``(B, m, n)`` stack -> packed, taus.  The kernel path factors the
    ``k = min(m, n)`` pivot columns with one ``mht_panel`` launch for the
    whole stack; on a wide matrix the columns past them then take the k
    reflectors' block update, one ``wy_trailing`` launch (the reference's
    kernel path loops over all n columns instead and returns n taus)."""
    if not cfg.use_kernel:
        return geqr2_ht(a)
    from repro_torch.core.blocked import larft, unpack_v_panel
    from repro_torch.kernels import ops

    k = min(a.shape[-2:])
    packed = a.clone(memory_format=torch.contiguous_format)
    taus = ops.mht_panel_(packed[..., :k])
    if a.shape[-1] > k:
        v = unpack_v_panel(packed[..., :k], 0)
        ops.wy_trailing_(v, larft(v, taus), packed[..., k:])
    return packed, taus


def _smem_geqr2_ht(m: int, n: int, cfg: QRConfig, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the kernel path: the panel kernel on the
    pivot columns, the trailing kernel on a wide matrix's rest and in Q
    formation (panels of ``cfg.block``)."""
    from repro_torch.kernels import ops

    k = min(m, n)
    return ops.panel_path_smem_bytes(m, k, (k, min(cfg.block, k)), itemsize)


register_method(MethodSpec(
    name="geqr2_ht",
    factor=_factor_geqr2_ht,
    kernel_backed=True,
    smem_bytes=_smem_geqr2_ht,
    description="MHT, fused macro-op updates (LAPACK DGEQR2HT)",
))
