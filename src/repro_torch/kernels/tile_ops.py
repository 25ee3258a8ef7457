"""Single-tile TSQRT and SSRFB entry points.

Counterpart of the reference's ``repro.kernels.tile_ops``, whose one-cell
kernels run the same macro-op bodies as its wavefront kernels.  Here too:
on a CUDA tensor each entry stages its tiles into a small tile workspace
and launches the wavefront kernel of ``csrc/macro_ops.cu`` for one task,
so the single-tile result comes from the same ``tsqrt_task`` /
``ssrfb_task`` body as the tiled path, counted as ``TSQRT_TILE`` /
``SSRFB_TILE`` in ``macro_ops.LAUNCHES``.  On a CPU tensor each runs the
plain body (:func:`macro_ops.tsqrt_factor`, :func:`macro_ops.ssrfb_body`).

  * **TSQRT** — QR of the stacked pair ``[R; A]`` (R upper triangular on
    top, what lies below its diagonal passes through) -> ``(R new, V2,
    taus)``.
  * **SSRFB** — apply a TSQRT block reflector to a tile pair: with
    ``V = [I; V2]``, ``W = T^T (C_k + V2^T C_i)``, ``C_k -= W``,
    ``C_i -= V2 W``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.plan import (DEFAULT_SMEM_BUDGET, KernelPolicy,
                                   register_kernel_policy)
from repro_torch.kernels import macro_ops

__all__ = ["tsqrt", "ssrfb", "smem_bytes_tsqrt", "smem_bytes_ssrfb"]

Tensor = torch.Tensor

_POLICY = register_kernel_policy(KernelPolicy("tile_ops", DEFAULT_SMEM_BUDGET))

# The one task's (k, i, j) per (kind, device), uploaded once: a fresh
# host-to-device copy per call would wait for the stream.
_TASK = {"TSQRT": (0, 1, 0), "SSRFB": (0, 1, 1)}
_IDX = {}


def _task_index(kind: str, device: torch.device) -> Tensor:
    key = (kind, str(device))
    if key not in _IDX:
        _IDX[key] = torch.tensor([_TASK[kind]], dtype=torch.int32,
                                 device=device)
    return _IDX[key]


def smem_bytes_tsqrt(nb: int, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the TSQRT kernel at tile size nb."""
    return macro_ops.smem_bytes("TSQRT", nb, itemsize)


def smem_bytes_ssrfb(nb: int, itemsize: int = 4) -> int:
    """Per-CTA shared memory of the SSRFB kernel at tile size nb."""
    return macro_ops.smem_bytes("SSRFB", nb, itemsize)


def _check(name: str, tiles: Tuple[Tensor, ...], smem: int) -> int:
    nb = tiles[0].shape[0]
    for x in tiles:
        if tuple(x.shape) != (nb, nb):
            raise ValueError(f"{name} expects square same-shape tiles, got "
                             f"{[tuple(t.shape) for t in tiles]}")
        if x.device != tiles[0].device or x.dtype != tiles[0].dtype:
            raise ValueError(f"{name}: tiles must share one device and dtype")
    if smem > _POLICY.smem_budget:
        raise ValueError(f"{name}: tile ({nb},{nb}) needs {smem} B of shared "
                         f"memory > {_POLICY.smem_budget} B; shrink the tile")
    return nb


def tsqrt(r_t: Tensor, a_t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Stacked-triangle QR of ``[R; A]`` -> ``(R new, V2, taus)``.
    Oracle: :func:`repro_torch.kernels.ref.tsqrt_ref`."""
    nb = _check("tsqrt", (r_t, a_t),
                smem_bytes_tsqrt(r_t.shape[0], r_t.element_size()))
    if r_t.device.type == "cpu":
        merged, v2, taus = macro_ops.tsqrt_factor(r_t[None], a_t[None])
        return merged[0], v2[0], taus[0]
    # Workspace (p, q) = (2, 1): diagonal tile (0, 0) = R, tile (1, 0) = A;
    # one TSQRT task (k, i, j) = (0, 1, 0).
    ws = torch.stack([r_t, a_t])[:, None].contiguous()
    t_t = ws.new_empty((2, 1, nb, nb))
    t_taus = ws.new_empty((2, 1, nb))
    idx = _task_index("TSQRT", ws.device)
    macro_ops._check("TSQRT", ws, (t_t, t_taus), idx)
    macro_ops._launch("TSQRT", ws, (t_t, t_taus), idx, tally="TSQRT_TILE")
    return ws[0, 0], ws[1, 0], t_taus[1, 0]


def ssrfb(v2: Tensor, t: Tensor, ck: Tensor, ci: Tensor
          ) -> Tuple[Tensor, Tensor]:
    """Apply the TSQRT reflectors ``[I; V2]`` (block reflector ``t``) to
    the tile pair ``[C_k; C_i]`` -> ``(C_k, C_i)``.  Oracle:
    :func:`repro_torch.kernels.ref.ssrfb_ref`."""
    nb = _check("ssrfb", (v2, t, ck, ci),
                smem_bytes_ssrfb(v2.shape[0], v2.element_size()))
    if v2.device.type == "cpu":
        out_k, out_i = macro_ops.ssrfb_body(v2[None], t[None], ck[None],
                                            ci[None])
        return out_k[0], out_i[0]
    # Workspace (p, q) = (2, 2): tile (1, 0) = V2, (0, 1) = C_k, (1, 1) =
    # C_i, T at t_t[1, 0]; one SSRFB task (k, i, j) = (0, 1, 1).
    ws = v2.new_zeros((2, 2, nb, nb))
    ws[0, 1], ws[1, 0], ws[1, 1] = ck, v2, ci
    t_t = t.new_zeros((2, 2, nb, nb))
    t_t[1, 0] = t
    idx = _task_index("SSRFB", ws.device)
    macro_ops._check("SSRFB", ws, (t_t,), idx)
    macro_ops._launch("SSRFB", ws, (t_t,), idx, tally="SSRFB_TILE")
    return ws[0, 1], ws[1, 1]
