"""Blocked (WY-representation) Householder QR — ``DGEQRF`` / ``DGEQRFHT``.

Counterpart of the reference's ``repro.core.blocked``, on tensors with
leading batch dimensions.  Paper §2.3/§4: a b-column *panel* is factored
with the unblocked transform (classical HT or MHT), its reflectors are
accumulated into the compact WY form

    H_{j0} H_{j0+1} ... H_{j0+b-1} = I - V T V^T        (T upper triangular)

and the aggregate is applied to the trailing matrix with three products,
``C <- C - V (T^T (V^T C))``.  ``DGEQRFHT`` is this routine with MHT
panels.  With ``use_kernel=True`` each panel runs in the hand-written
``mht_panel`` kernel and each trailing update in the ``wy_trailing``
kernel (:mod:`repro_torch.kernels.ops`), one launch per panel step for a
whole stack of matrices.  Q is formed the same way, panel by panel
(:func:`apply_q_blocked`).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.householder import (_two_pass_update_,
                                          _write_packed_column, house_vector)
from repro_torch.core.mht import _mht_update_
from repro_torch.kernels.macro_ops import wy_body

__all__ = ["larft", "unpack_v_panel", "panel_factor", "wy_apply", "geqrf",
           "geqrf_fori", "apply_q_blocked", "form_q_blocked"]

Tensor = torch.Tensor


def larft(v: Tensor, taus: Tensor) -> Tensor:
    """Upper-triangular block reflectors T (``DLARFT``, forward,
    columnwise) of a batch: ``v`` is ``(..., m, b)`` unit-lower-trapezoidal,
    ``taus`` is ``(..., b)``, and ``H_0 .. H_{b-1} = I - V T V^T``.

    The reference forms T one column at a time, ``T[:i, i] = -tau_i
    T[:i, :i] V[:, :i]^T v_i`` — back substitution for the inverse of
    ``M = diag(1 / tau) + striu(V^T V)``.  This takes that inverse with one
    batched triangular solve.  A reflector with ``tau = 0`` (H = I) gets a
    zero row and column in T, as in the recurrence: its row and column of
    ``M`` are decoupled (unit diagonal, no Gram entries) and its diagonal
    entry of T is zeroed after the solve."""
    b = v.shape[-1]
    live = taus != 0
    gram = torch.triu(v.mT @ v, 1) * (live[..., :, None] & live[..., None, :])
    m = gram + torch.diag_embed(torch.where(live, 1.0 / taus, 1.0))
    eye = torch.eye(b, dtype=v.dtype, device=v.device).expand(m.shape)
    t = torch.linalg.solve_triangular(m, eye, upper=True)
    return t * torch.where(live, 1.0, 0.0).to(t.dtype)[..., None, :]


def unpack_v_panel(panel: Tensor, row0: int) -> Tensor:
    """Unit-lower-trapezoidal V of a packed ``(..., m, b)`` panel whose
    column ``j`` pivots at row ``row0 + j``."""
    m, b = panel.shape[-2:]
    eye = torch.eye(m, row0 + b, dtype=panel.dtype, device=panel.device)
    return torch.tril(panel, -row0 - 1) + eye[:, row0:]


def panel_factor(panel: Tensor, row0: int, *, method: str = "mht"
                 ) -> Tuple[Tensor, Tensor]:
    """Factor ``(..., m, b)`` panels whose pivot rows start at ``row0``;
    rows above each column's pivot are preserved.  ``method``: "mht"
    (fused update) or "ht" (classical two passes).  Returns ``(packed,
    taus)`` with b taus."""
    if method not in ("mht", "ht"):
        raise ValueError(f"unknown panel method: {method!r}")
    b = panel.shape[-1]
    p = panel.clone()
    taus = p.new_zeros(p.shape[:-2] + (b,))
    for lj in range(b):
        pivot = row0 + lj
        v, tau, beta = house_vector(p[..., :, lj], pivot)
        update = _mht_update_ if method == "mht" else _two_pass_update_
        update(p, v, tau, lj)
        _write_packed_column(p, v, beta, lj, pivot)
        taus[..., lj] = tau
    return p, taus


def wy_apply(v: Tensor, t: Tensor, c: Tensor, *, use_kernel: bool = False
             ) -> Tensor:
    """Trailing update ``C <- C - V (T^T (V^T C))`` (applies Q^T); the
    kernel path is one ``wy_trailing`` launch."""
    if use_kernel:
        from repro_torch.kernels import ops

        return ops.wy_trailing(v, t, c)
    return wy_body(v, t, c)


def _as_stack(a: Tensor) -> Tensor:
    m, n = a.shape[-2:]
    return a.reshape((math.prod(a.shape[:-2]), m, n)).clone(memory_format=torch.contiguous_format)


def geqrf(a: Tensor, *, block: int = 32, panel_method: str = "mht",
          use_kernel: bool = False) -> Tuple[Tensor, Tensor]:
    """Blocked WY QR of ``(..., m, n)`` matrices: ``panel_method="ht"`` is
    DGEQRF, ``"mht"`` DGEQRFHT.  Returns ``(packed, taus)`` in the layout
    of :func:`repro_torch.core.householder.geqr2`.

    Panel ``[j0, j0 + bw)`` is factored on its rows from ``j0`` down (the
    rows above keep their R entries), which is ``mht_panel`` at ``row0 =
    j0``; its V is zero above row ``j0``, so the trailing update runs on
    ``C[j0:, j0 + bw:]`` too.  With ``use_kernel`` both run in place in
    the kernels, one launch each per panel step for the whole stack, and
    ``panel_method`` must be "mht"."""
    if use_kernel and panel_method != "mht":
        raise ValueError("the panel kernel realizes MHT panels only")
    lead = a.shape[:-2]
    m, n = a.shape[-2:]
    k = min(m, n)
    a = _as_stack(a)
    taus = a.new_zeros((a.shape[0], k))
    if use_kernel:
        from repro_torch.kernels import ops
    j0 = 0
    while j0 < k:
        bw = min(block, k - j0)
        panel = a[:, j0:, j0:j0 + bw]
        if use_kernel:
            taus_p = ops.mht_panel_(panel)
        else:
            packed, taus_p = panel_factor(panel, 0, method=panel_method)
            panel.copy_(packed)
        taus[:, j0:j0 + bw] = taus_p
        if j0 + bw < n:
            v = unpack_v_panel(panel, 0)
            t = larft(v, taus_p)
            c = a[:, j0:, j0 + bw:]
            if use_kernel:
                ops.wy_trailing_(v, t, c)
            else:
                c.copy_(wy_apply(v, t, c))
        j0 += bw
    return a.reshape(lead + (m, n)), taus.reshape(lead + (k,))


def geqrf_fori(a: Tensor, *, block: int = 128) -> Tuple[Tensor, Tensor]:
    """Blocked MHT QR with full-width trailing updates under a column mask
    — the reference's O(1)-HLO optimizer path (``fori_loop`` over panels),
    ~2x the FLOPs of :func:`geqrf`.  Requires ``min(m, n) % block == 0``
    (callers pad)."""
    m, n = a.shape[-2:]
    k = min(m, n)
    if k % block != 0:
        raise ValueError(f"min(m,n)={k} not divisible by block={block}")
    a = a.clone()
    taus = a.new_zeros(a.shape[:-2] + (k,))
    colmask = torch.arange(n, device=a.device)[None, :]
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j0 in range(0, k, block):
        panel_f, taus_p = panel_factor(a[..., :, j0:j0 + block], j0)
        a[..., :, j0:j0 + block] = panel_f
        taus[..., j0:j0 + block] = taus_p
        v = unpack_v_panel(panel_f, j0)
        w = larft(v, taus_p).mT @ (v.mT @ a)
        a = a - torch.where(colmask >= j0 + block, v @ w, zero)
    return a, taus


def _panel_reflectors(packed: Tensor, taus: Tensor, block: int):
    """Per panel of ``block`` columns, from the last: ``(j0, V, T)`` with
    V on rows ``j0:`` (``(B, m - j0, bw)``).  T of all full-width panels
    comes from one batched :func:`larft`."""
    k = taus.shape[-1]
    starts = list(range(0, k, block))
    full = [j0 for j0 in starts if j0 + block <= k]
    ts = {}
    if full:
        vs = torch.stack([unpack_v_panel(packed[:, :, j0:j0 + block], j0)
                          for j0 in full], dim=1)
        tt = larft(vs, torch.stack([taus[:, j0:j0 + block] for j0 in full],
                                   dim=1))
        ts = {j0: tt[:, n] for n, j0 in enumerate(full)}
    for j0 in reversed(starts):
        bw = min(block, k - j0)
        v = unpack_v_panel(packed[:, j0:, j0:j0 + bw], 0)
        t = ts[j0] if j0 in ts else larft(v, taus[:, j0:j0 + bw])
        yield j0, v, t


def _apply_panels(packed: Tensor, taus: Tensor, c: Tensor, *, block: int,
                  transpose: bool, use_kernel: bool, identity: bool) -> Tensor:
    lead = c.shape[:-2]
    nmat = math.prod(lead)
    packed = packed.reshape((nmat,) + packed.shape[-2:])
    taus = taus.reshape((nmat, taus.shape[-1]))
    out = c.reshape((nmat,) + c.shape[-2:]).clone(
        memory_format=torch.contiguous_format)
    if use_kernel:
        from repro_torch.kernels import ops
    steps = list(_panel_reflectors(packed, taus, block))
    for j0, v, t in (reversed(steps) if transpose else steps):
        tt = t if transpose else t.mT
        # V is zero above row j0; on the identity, back to front, the
        # columns before j0 are still unit columns when panel j0 comes.
        sub = out[:, j0:, j0:] if identity else out[:, j0:, :]
        if use_kernel:
            ops.wy_trailing_(v, tt, sub, tally="WY_TRAILING_Q")
        else:
            sub.copy_(wy_apply(v, tt, sub))
    return out.reshape(lead + out.shape[-2:])


def apply_q_blocked(packed: Tensor, taus: Tensor, c: Tensor, *,
                    block: int = 32, transpose: bool = False,
                    use_kernel: bool = False) -> Tensor:
    """Apply Q (or Q^T) of a packed factorization of ``(..., m, n)``
    matrices to ``c`` ``(..., m, p)`` panel by panel, with each panel's
    compact WY form: Q back to front, ``C <- C - V (T (V^T C))``; Q^T front
    to back, ``C <- C - V (T^T (V^T C))``.  ``use_kernel``: each panel is
    one ``wy_trailing`` launch (counted as ``WY_TRAILING_Q``) for the
    whole stack.  The one-reflector-at-a-time
    :func:`repro_torch.core.householder.apply_q` is its plain version."""
    return _apply_panels(packed, taus, c, block=block, transpose=transpose,
                         use_kernel=use_kernel, identity=False)


def form_q_blocked(packed: Tensor, taus: Tensor, *, block: int = 32,
                   full: bool = False, use_kernel: bool = False) -> Tensor:
    """Materialize Q — thin (m x k) or full (m x m) — by applying the
    panels back to front to the identity, each to the rows and columns it
    reaches."""
    m = packed.shape[-2]
    cols = m if full else taus.shape[-1]
    eye = torch.eye(m, cols, dtype=packed.dtype, device=packed.device)
    return _apply_panels(packed, taus, eye.expand(packed.shape[:-2] + (m, cols)),
                         block=block, transpose=False, use_kernel=use_kernel,
                         identity=True)


# -- registry -----------------------------------------------------------------
from repro_torch.core.plan import MethodSpec, QRConfig, register_method  # noqa: E402


def _smem_geqrf_panel(m: int, n: int, cfg: QRConfig, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the kernel path: the tallest panel (the
    first, ``(m, bw)``) and the trailing kernel with ``bw`` reflectors."""
    from repro_torch.kernels import ops

    bw = min(cfg.block, m, n)
    return ops.panel_path_smem_bytes(m, bw, (bw,), itemsize)


register_method(MethodSpec(
    name="geqrf",
    factor=lambda a, cfg: geqrf(a, block=cfg.block, panel_method="ht",
                                use_kernel=False),
    description="blocked WY, classical HT panels (LAPACK DGEQRF)",
))

register_method(MethodSpec(
    name="geqrf_ht",
    factor=lambda a, cfg: geqrf(a, block=cfg.block, panel_method="mht",
                                use_kernel=bool(cfg.use_kernel)),
    kernel_backed=True,
    smem_bytes=_smem_geqrf_panel,
    description="blocked WY, MHT panels (LAPACK DGEQRFHT) [default]",
))


def _resolve_geqrf_fori(m: int, n: int, cfg: QRConfig, *, dtype=None,
                        explain=None) -> QRConfig:
    if min(m, n) % cfg.block != 0:
        raise ValueError(
            f"geqrf_fori needs min(m,n) divisible by block "
            f"(got {m}x{n}, block={cfg.block}); callers pad")
    return cfg


register_method(MethodSpec(
    name="geqrf_fori",
    factor=lambda a, cfg: geqrf_fori(a, block=cfg.block),
    resolve=_resolve_geqrf_fori,
    description="blocked MHT with fori_loop panels — O(1)-HLO optimizer path",
))
