"""QR domain groups: the process-group plumbing of the sharded tiled QR
and the collective TSQR.

Counterpart of the QR-domain part of the reference's
``repro.distributed.sharding`` (``QR_DOMAIN_AXIS``, ``largest_pow2``,
``row_domain_mesh``).  The reference runs one row-block domain per
device of a 1-D JAX mesh inside ``shard_map``; the port runs one per
rank of a ``torch.distributed`` process group, each rank a process
(SPMD: every rank calls the same function with the same arguments).
``row_domain_specs`` has no counterpart: a rank slices its own rows
explicitly.  The training meshes (``MeshRules`` and the spec functions)
are ROADMAP A21.

The collectives below run over a group (None: the default group) and
take their backend from it.  A backend
that moves device memory itself (NCCL) gets the tensors where they are;
any other (gloo, which ranks sharing one card must use: NCCL refuses two
ranks on one device) gets a host copy, and the result is copied back to
the tensor's device.  Point-to-point exchanges go through
``batch_isend_irecv``.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch.observability import trace as _trace

__all__ = ["QR_DOMAIN_AXIS", "largest_pow2", "world_size", "group_size",
           "group_rank", "resolve_group", "row_domain_mesh", "exchange",
           "all_gather_rows", "all_reduce_sum", "broadcast_from_first"]

# The reference's mesh-axis name; here it labels metrics and spans.
QR_DOMAIN_AXIS = "qr_domain"

# Backends that move CUDA tensors themselves; the rest are staged through
# host memory.
_DEVICE_BACKENDS = ("nccl",)

# One subgroup per (parent group, domain count): ``dist.new_group`` is
# collective over the default group, so every rank creates it, once, in
# the same order.
_SUBGROUPS: dict = {}


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1) — butterfly trees need 2^k
    participants, so domain counts round down."""
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    return 1 << (int(n).bit_length() - 1)


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The default process group's size when ``torch.distributed`` is
    initialized, else 1: the ranks a sharded solve can run over (the
    reference counts ``jax.local_device_count()``)."""
    return dist.get_world_size() if _initialized() else 1


def group_size(group=None) -> int:
    """The size of ``group`` (None: the default group, or 1 when
    ``torch.distributed`` is not initialized)."""
    return world_size() if group is None else dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    if group is None and not _initialized():
        return 0
    return dist.get_rank(group)


def resolve_group(group=None):
    """``group``, or the default group for None."""
    return dist.group.WORLD if group is None else group


def row_domain_mesh(ndomains: int, group=None):
    """The process group of the first ``ndomains`` ranks of ``group``
    (default: the default group): ``group`` itself when it has exactly
    that many ranks, None without a process group (``ndomains`` 1).

    Creating a subgroup is collective over the default group: every rank
    of it must call this with the same ``ndomains``, in the same order;
    each subgroup is created once and cached.  A rank outside the
    subgroup gets ``dist.GroupMember.NON_GROUP_MEMBER``."""
    size = group_size(group)
    if ndomains < 1 or ndomains > size:
        raise ValueError(
            f"need 1 <= ndomains <= {size} ranks, got {ndomains}")
    if not _initialized():
        return None
    parent = resolve_group(group)
    if ndomains == size:
        return parent
    key = (parent, ndomains)
    if key not in _SUBGROUPS:
        ranks = [dist.get_global_rank(parent, r) for r in range(ndomains)]
        _SUBGROUPS[key] = dist.new_group(ranks)
    return _SUBGROUPS[key]


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` as the group's backend sends it: itself, or a host copy."""
    if t.is_cuda and dist.get_backend(group) not in _DEVICE_BACKENDS:
        t = t.to("cpu")
    return t.contiguous()


def exchange(t: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Send ``t`` to group rank ``peer`` and return ``peer``'s tensor of
    the same shape and dtype (one ``batch_isend_irecv`` pair), on ``t``'s
    device."""
    group = resolve_group(group)
    with _trace.span("distributed.collective", op="exchange",
                     axis=QR_DOMAIN_AXIS) as sp:
        send = _wire(t, group)
        recv = torch.empty_like(send)
        other = dist.get_global_rank(group, peer)
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, other, group),
                dist.P2POp(dist.irecv, recv, other, group)]):
            work.wait()
        return sp.sync(recv.to(t.device))


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) stacked along dim 0 in rank
    order, on every rank, on ``t``'s device."""
    group = resolve_group(group)
    with _trace.span("distributed.collective", op="all_gather",
                     axis=QR_DOMAIN_AXIS) as sp:
        send = _wire(t, group)
        parts: List[torch.Tensor] = [torch.empty_like(send)
                                     for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, send, group=group)
        return sp.sync(torch.cat(parts).to(t.device))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, on every rank (a new tensor on
    ``t``'s device)."""
    group = resolve_group(group)
    with _trace.span("distributed.collective", op="all_reduce",
                     axis=QR_DOMAIN_AXIS) as sp:
        buf = _wire(t, group)
        if buf is t:
            buf = t.clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return sp.sync(buf.to(t.device))


def broadcast_from_first(t: torch.Tensor, group,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Group rank 0's ``t`` on every rank of ``group``: rank 0 passes its
    tensor, the others ``out``, an empty tensor of the same shape and
    dtype whose device receives the result."""
    group = resolve_group(group)
    with _trace.span("distributed.collective", op="broadcast",
                     axis=QR_DOMAIN_AXIS) as sp:
        dest = t if dist.get_rank(group) == 0 else out
        buf = _wire(dest, group)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        return sp.sync(buf.to(dest.device))
