"""Placement of tensors over ranks: the QR domain groups of the sharded
tiled QR and the collective TSQR, and the training meshes' sharding
rules as DTensor placements.

Counterpart of the reference's ``repro.distributed.sharding``.

**QR domains** (``QR_DOMAIN_AXIS``, ``largest_pow2``,
``row_domain_mesh``).  The reference runs one row-block domain per device
of a 1-D JAX mesh inside ``shard_map``; the port runs one per rank of a
``torch.distributed`` process group, each rank a process (SPMD: every
rank calls the same function with the same arguments, which
:func:`check_same_copies` verifies where a solve depends on it).
``row_domain_specs`` has no counterpart: a rank slices its own rows
explicitly.

The collectives below run over a group (None: the default group) and
take their backend from it.  A backend
that moves device memory itself (NCCL) gets the tensors where they are;
any other (gloo, which ranks sharing one card must use: NCCL refuses two
ranks on one device) gets a host copy, and the result is copied back to
the tensor's device.  Point-to-point exchanges go through
``batch_isend_irecv``.

**Training meshes** (``MeshRules``, ``param_specs``, ``state_specs``,
``batch_specs``, ``cache_specs``; MaxText-style "fsdp + tensor"):

  * ``model`` axis: the output/head/vocab dimension of each weight;
  * ``data`` axes (``("pod", "data")`` on the multi-pod mesh): the
    contraction (embed/ff) dimension — parameters and optimizer state
    sharded ZeRO-3 style;
  * batch over the data axes; a batch of one shards its sequence instead.

Every rule degrades to replication (None) when a dimension does not
divide by the axis size.  A spec is a :class:`Spec`: one entry per
tensor dimension, each None, a mesh-axis name, or a tuple of names
(major first), the counterpart of a ``PartitionSpec``.  The spec
functions are pure functions of names, shapes and axis sizes, so
:class:`MeshRules` works over a ``DeviceMesh`` or over a plain
``{axis: size}`` mapping (the 256- and 512-rank production meshes, on
one machine).  :func:`placements` maps a spec onto a ``DeviceMesh`` as
DTensor ``Shard``/``Replicate`` placements, one per mesh dimension; a
tensor dimension sharded over two axes is split major first, as JAX
splits it.  :func:`distribute_tree` places a tree by slicing each rank's
shard out of its own copy: no collective, and no bit of a shard changes.

**Activation constraints** (``activation_policy``, ``constrain_hidden``,
``constrain_logits``): inside a policy, a DTensor activation is
redistributed to the placements its spec asks for; a plain tensor, or
any tensor outside a policy, passes through.  The port's train step runs
the model on each rank's own batch shard as plain tensors (the layout
``constrain_hidden`` asks for), so there they are no-ops; they act on a
forward pass run on DTensors.  The expert and decode constraints come
with ROADMAP A16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.observability import trace as _trace

__all__ = ["QR_DOMAIN_AXIS", "largest_pow2", "world_size", "group_size",
           "group_rank", "resolve_group", "row_domain_mesh", "exchange",
           "all_gather_rows", "all_reduce_sum", "broadcast_from_first",
           "DivergentCopiesError", "fingerprint", "check_same_copies",
           "Spec", "MeshRules", "axis_sizes", "param_specs", "state_specs",
           "batch_specs", "cache_specs", "placements", "tree_placements",
           "local_shard", "distribute", "distribute_tree", "map_with_names",
           "leaves_with_names",
           "shard_like", "map_local", "mesh_sum", "redistribute",
           "full_tensor",
           "activation_policy", "constrain_hidden", "constrain_logits"]

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


class DivergentCopiesError(ValueError):
    """The ranks of a group were handed different copies of a matrix that
    an SPMD solve needs to be the same on every rank."""


# Fixed slots of a fingerprint: ndim, up to _FP_DIMS extents, dtype (its
# index here), the entries' sum and _FP_PROBES seeded bilinear probes.
_FP_DIMS = 8
_FP_PROBES = 2
_FP_SEED = 0x5EED
_DTYPES = [torch.float64, torch.float32, torch.bfloat16, torch.float16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """A float64 vector that identifies ``t`` across ranks: its ndim,
    shape and dtype, the sum of its entries and ``_FP_PROBES`` bilinear
    probes ``u^T X v`` of ``t`` as a (rows, rest) matrix X, with ``u``
    and ``v`` drawn from a fixed seed on the host (the same bits on every
    rank), all computed in float64 on ``t``'s device.  A change that
    keeps a probe equal must lie on the hyperplane the random ``u v^T``
    fixes, so no structured difference (a permutation, a +e/-e pattern on
    a rectangle's corners) escapes it."""
    if t.ndim > _FP_DIMS:
        raise ValueError(f"fingerprint takes up to {_FP_DIMS} dims, got {t.ndim}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"fingerprint takes real dtypes, got {t.dtype}")
    f64 = torch.float64
    x = t.detach().reshape(t.shape[0] if t.ndim else 1, -1).to(f64)
    gen = torch.Generator().manual_seed(_FP_SEED)
    u = torch.rand(_FP_PROBES, x.shape[0], generator=gen, dtype=f64)
    v = torch.rand(x.shape[1], _FP_PROBES, generator=gen, dtype=f64)
    probes = ((u.to(t.device) @ x) * (v.to(t.device)).T).sum(dim=1)
    head = torch.tensor([t.ndim] + list(t.shape) + [-1] * (_FP_DIMS - t.ndim)
                        + [_DTYPES.index(t.dtype)], dtype=f64,
                        device=t.device)
    return torch.cat([head, x.sum()[None], probes])


def check_same_copies(t: torch.Tensor, group=None, *, what: str = "matrix"
                      ) -> None:
    """Raise :class:`DivergentCopiesError` on every rank of ``group``
    (None: the default group) unless every rank holds the same ``t``:
    one all-gather of :func:`fingerprint`, compared bit for bit (a NaN
    matches itself), so all ranks reach the same verdict."""
    if group_size(group) == 1:
        return
    with _trace.span("distributed.fingerprint", what=what):
        prints = all_gather_rows(fingerprint(t)[None], group).cpu()
    bits = prints.view(torch.int64)
    differ = [r for r in range(1, bits.shape[0])
              if not torch.equal(bits[r], bits[0])]
    if differ:
        raise DivergentCopiesError(
            f"the ranks hold different copies of the {what}: group ranks "
            f"{differ} differ from rank 0 in shape, dtype or checksum; an "
            f"SPMD solve over the group needs the same {what} on every "
            f"rank (a rank's own {what} belongs in a local solve: no "
            f"ndomains > 1, no method='sharded_tiled')")


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


# ------------------------------------------------------------ training meshes

# Weight names whose first dim is the TP (model) dim: projections back to
# d_model, whose contraction dim (ff/heads) is tensor-parallel.
_DOWN_TYPE = ("down", "wo", "out_proj", "out", "down_w")
_EXCLUDE_MODEL = ("router", "shared_gate", "qnorm", "knorm")


class Spec(tuple):
    """Per-dimension mesh axes of one tensor: each entry None, an axis
    name, or a tuple of names (major first).  A tuple subclass, so a spec
    tree's leaves are told apart from the tuples of the tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (its dim names, in mesh
    order) or of a mapping that already is one."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    raise TypeError(f"expected a DeviceMesh or an {{axis: size}} mapping, "
                    f"got {type(mesh).__name__}")


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """The sharding policy over ``mesh`` (a ``DeviceMesh`` with named
    dims, or an ``{axis: size}`` mapping).  ``tp_enabled=False``: no
    tensor parallelism (the small-model policy).  ``batch_axes``: the
    axes the batch shards over (default: ``data_axes``)."""

    mesh: Any
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    tp_enabled: bool = True
    batch_axes: Optional[Tuple[str, ...]] = None

    @property
    def sizes(self) -> dict:
        return axis_sizes(self.mesh)

    @property
    def data_size(self) -> int:
        return math.prod(self.sizes[a] for a in self.data_axes)

    @property
    def model_size(self) -> int:
        return int(self.sizes[self.model_axis])

    def data_spec(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    @property
    def batch_axes_eff(self) -> Tuple[str, ...]:
        return self.batch_axes if self.batch_axes is not None else self.data_axes

    @property
    def batch_size_eff(self) -> int:
        return math.prod(self.sizes[a] for a in self.batch_axes_eff)

    def batch_spec(self):
        ax = self.batch_axes_eff
        return ax if len(ax) > 1 else ax[0]


def _div(n: int, k: int) -> bool:
    return n % k == 0


def _weight_spec(names, shape, rules: MeshRules) -> Spec:
    """Spec of an unstacked weight leaf (the reference's rules)."""
    ds, ms = rules.data_size, rules.model_size
    dspec, m = rules.data_spec(), rules.model_axis
    nd = len(shape)

    if nd == 1:
        # gains/biases: big vectors over data, small ones replicated
        return Spec(dspec) if shape[0] >= 4096 and _div(shape[0], ds) \
            else Spec(None)

    no_model = any(n in _EXCLUDE_MODEL for n in names) or not rules.tp_enabled
    down_type = any(n in _DOWN_TYPE for n in names)

    if nd == 2:
        if "table" in names:  # embedding (V, d): vocab-parallel + fsdp
            return Spec(m if _div(shape[0], ms) else None,
                        dspec if _div(shape[1], ds) else None)
        if "lm_head" in names:  # (d, V): vocab-parallel output
            return Spec(dspec if _div(shape[0], ds) else None,
                        m if _div(shape[1], ms) else None)
        if down_type:  # (ff/heads, d): TP on contraction, fsdp on output
            return Spec(m if _div(shape[0], ms) and not no_model else None,
                        dspec if _div(shape[1], ds) else None)
        # up-type (d, ff/heads): fsdp on contraction, TP on output
        return Spec(dspec if _div(shape[0], ds) else None,
                    m if _div(shape[1], ms) and not no_model else None)

    if nd == 3:
        # expert stacks (E, d, f) / (E, f, d); xLSTM blocks (H, dh, ...)
        if _div(shape[0], ms) and not no_model:
            return Spec(m, dspec if _div(shape[1], ds) else None, None)
        if down_type:
            return Spec(None, m if _div(shape[1], ms) and not no_model
                        else None, dspec if _div(shape[2], ds) else None)
        return Spec(None, dspec if _div(shape[1], ds) else None,
                    m if _div(shape[2], ms) and not no_model else None)

    return Spec(*([None] * nd))


def _is_container(x) -> bool:
    return isinstance(x, (dict, list)) or (
        isinstance(x, tuple) and not isinstance(x, Spec))


def leaves_with_names(tree, names=()):
    """``(names, leaf)`` of every leaf, in tree order.  Dict keys split on
    dots (a flat ``named_parameters`` dict names its leaves as the nested
    tree does), NamedTuple fields by name, sequence items by index."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_names(v, names + tuple(str(k).split(".")))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaves_with_names(getattr(tree, f), names + (f,))
    elif _is_container(tree):
        for i, v in enumerate(tree):
            yield from leaves_with_names(v, names + (str(i),))
    else:
        yield names, tree


def map_with_names(fn: Callable, tree, names=()):
    """``tree`` with each leaf replaced by ``fn(names, leaf)`` (same
    structure; NamedTuples keep their type)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, names + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f), names + (f,))
                            for f in tree._fields))
    if _is_container(tree):
        return type(tree)(map_with_names(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def _map2(fn: Callable, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map2(fn, getattr(tree, f), getattr(other, f))
                            for f in tree._fields))
    if _is_container(tree):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def param_specs(params: Any, rules: MeshRules) -> Any:
    """Spec tree of a parameter tree (leaves: anything with ``.shape``).
    Leaves under ``layers`` carry a leading period axis, never sharded."""

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        if "layers" in names and len(shape) >= 1:
            return Spec(None, *_weight_spec(names, shape[1:], rules))
        return _weight_spec(names, shape, rules)

    return map_with_names(spec, params)


def state_specs(params: Any, param_spec_tree: Any, state: Any,
                rules: MeshRules) -> Any:
    """Optimizer-state specs: a leaf whose path ends in a parameter's path
    takes that parameter's spec when their ranks match (moments,
    residuals); other leaves (steps, 0-d placeholders) are replicated."""
    shapes = {n: _ndim(l) for n, l in leaves_with_names(params)}
    specs = dict(leaves_with_names(param_spec_tree))

    def spec(names, leaf):
        for start in range(len(names)):
            key = names[start:]
            if key in shapes:
                return specs[key] if shapes[key] == _ndim(leaf) else Spec()
        return Spec()

    return map_with_names(spec, state)


def batch_specs(batch: Any, rules: MeshRules) -> Any:
    """Batch over the batch axes; the sequence for a batch that does not
    divide (batch 1)."""
    dspec, ds = rules.batch_spec(), rules.batch_size_eff

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return Spec()
        if _div(shape[0], ds):
            return Spec(dspec, *([None] * (len(shape) - 1)))
        if len(shape) >= 2 and _div(shape[1], ds):
            return Spec(None, dspec, *([None] * (len(shape) - 2)))
        return Spec(*([None] * len(shape)))

    return map_with_names(spec, batch)


def cache_specs(caches: Any, rules: MeshRules) -> Any:
    """Decode-cache specs.  The leading period axis is never sharded;
    then batch -> data, heads -> model, else sequence -> model / data
    (length-sharded KV for batch-1 decode)."""
    dspec, ds, ms = rules.data_spec(), rules.data_size, rules.model_size
    m = rules.model_axis

    def spec(names, leaf):
        shape = tuple(leaf.shape)
        out: list = [None] * len(shape)
        if len(shape) < 2:
            return Spec(*out)
        dims = list(range(1, len(shape)))
        used_data = False
        if _div(shape[1], ds):
            out[1] = dspec
            used_data = True
        cand = [i for i in dims[1:] if _div(shape[i], ms)]
        pref = [i for i in cand if shape[i] <= 128] + \
               [i for i in cand if shape[i] > 128]
        if pref:
            out[pref[0]] = m
        if not used_data:
            rem = [i for i in dims[1:] if out[i] is None and _div(shape[i], ds)]
            if rem:
                out[max(rem, key=lambda i: shape[i])] = dspec
        return Spec(*out)

    return map_with_names(spec, caches)


def placements(spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dim d is split over that mesh axis, else
    ``Replicate()``.  A dim split over several axes lists them major
    first, in the mesh's own order."""
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {dim} over {axes}, "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


def tree_placements(spec_tree: Any, mesh: DeviceMesh) -> Any:
    """:func:`placements` of every spec of a tree (the reference's
    ``tree_shardings``)."""
    return map_with_names(lambda _, s: placements(s, mesh), spec_tree)


def local_shard(t: torch.Tensor, places, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``places``: a
    view of ``t``, sliced mesh dimension by mesh dimension (each sharded
    dim must divide)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            size = mesh.size(i)
            if t.shape[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not "
                                 f"divide over {size} ranks")
            t = t.chunk(size, dim=pl.dim)[coord[i]]
    return t


def _from_whole(t: torch.Tensor, mesh: DeviceMesh, places) -> DTensor:
    return DTensor.from_local(local_shard(t, places, mesh).contiguous(), mesh,
                              places, run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def distribute(t: torch.Tensor, spec, mesh: DeviceMesh) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor of
    ``spec`` on ``mesh``: each rank keeps its own shard, bit for bit, and
    nothing is communicated."""
    return _from_whole(t, mesh, placements(spec, mesh))


def distribute_tree(tree: Any, spec_tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor leaf of ``tree`` distributed by the spec at its place
    in ``spec_tree`` (:func:`distribute`); other leaves stay as they are.
    Leaves under ``layers`` keep their period axis unsharded, as
    :func:`param_specs` says."""
    return _map2(lambda t, s: distribute(t, s, mesh)
                 if isinstance(t, torch.Tensor) else t, tree, spec_tree)


# The host twin of a card mesh whose groups cannot carry device tensors
# (gloo): DTensor's collectives run there on host copies.
_HOST_TWINS: dict = {}


def _host_twin(mesh: DeviceMesh) -> Optional[DeviceMesh]:
    """The "cpu" ``DeviceMesh`` over ``mesh``'s ranks when ``mesh`` lies on
    a card and its backend is not one that moves device memory (ranks
    sharing a card run gloo, which fails on CUDA tensors), else None.
    Built on first use, which is collective: every rank reaches it at the
    same redistribution."""
    if mesh.device_type == "cpu" or \
            dist.get_backend(mesh.get_group(0)) in _DEVICE_BACKENDS:
        return None
    if mesh not in _HOST_TWINS:
        _HOST_TWINS[mesh] = DeviceMesh("cpu", mesh.mesh,
                                       mesh_dim_names=mesh.mesh_dim_names)
    return _HOST_TWINS[mesh]


def redistribute(x: DTensor, places) -> DTensor:
    """``x`` in ``places`` on its mesh: DTensor's redistribution, run on
    host copies where the mesh's backend needs them (:func:`_host_twin`).
    Not differentiable."""
    mesh, places = x.device_mesh, tuple(places)
    if tuple(x.placements) == places:
        return x
    if mesh.size() == 1:
        # One rank: its local tensor is the whole one under any placement
        # (a partial sum over one rank is the sum), nothing to exchange.
        return DTensor.from_local(x.to_local(), mesh, places, run_check=False,
                                  shape=x.shape, stride=x.stride())
    twin = _host_twin(mesh)
    with _trace.span("distributed.collective", op="redistribute",
                     axis="mesh", staged=twin is not None) as sp:
        if twin is None:
            return sp.sync(x.redistribute(mesh, places))
        host = DTensor.from_local(x.to_local().cpu(), twin, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
        local = host.redistribute(twin, places).to_local().to(x.device)
        return sp.sync(DTensor.from_local(local, mesh, places,
                                          run_check=False, shape=x.shape,
                                          stride=x.stride()))


def full_tensor(x: DTensor) -> torch.Tensor:
    """The whole tensor of ``x`` on every rank (an all-gather)."""
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def shard_like(t: torch.Tensor, like: DTensor) -> DTensor:
    """The whole tensor ``t`` (the same on every rank) placed as ``like``
    is: this rank's shard sliced out, no collective."""
    return _from_whole(t, like.device_mesh, tuple(like.placements))


def mesh_sum(t: torch.Tensor, mesh: DeviceMesh, dims=None) -> torch.Tensor:
    """The sum over the ranks of ``mesh`` dims ``dims`` (default: all) of
    each rank's ``t``, on every rank: one all-reduce a mesh dim, in mesh
    order, so every rank gets the same bits."""
    dims = range(mesh.ndim) if dims is None else dims
    places = [Partial() if i in dims else Replicate()
              for i in range(mesh.ndim)]
    x = DTensor.from_local(t, mesh, places, run_check=False)
    for i in sorted(dims):
        places[i] = Replicate()
        x = redistribute(x, places)
    return x.to_local()


def map_local(fn: Callable, *xs):
    """``fn`` on plain tensors, or on the local shards of DTensors that
    share one placement, each result wrapped back as such a DTensor (a
    tuple result wraps element by element).  For elementwise ``fn``
    only: a shard's result is the whole result's shard."""
    first = xs[0]
    if not isinstance(first, DTensor):
        return fn(*xs)
    for x in xs[1:]:
        if not isinstance(x, DTensor) or x.placements != first.placements:
            raise ValueError("map_local needs DTensors of one placement")
    out = fn(*(x.to_local() for x in xs))

    def wrap(o):
        return DTensor.from_local(o, first.device_mesh, first.placements,
                                  run_check=False, shape=first.shape,
                                  stride=first.stride())

    return tuple(wrap(o) for o in out) if isinstance(out, tuple) else wrap(out)


# ----------------------------------------------------------------- activations

_ACT_POLICY = threading.local()


@contextlib.contextmanager
def activation_policy(rules: MeshRules, *, seq_axis: Optional[str] = None):
    """Install the activation-sharding policy for model code run inside.
    ``seq_axis``: also shard the sequence dim of hidden states."""
    _ACT_POLICY.rules = rules
    _ACT_POLICY.seq_axis = seq_axis
    try:
        yield
    finally:
        _ACT_POLICY.rules = None
        _ACT_POLICY.seq_axis = None


def _policy() -> Tuple[Optional[MeshRules], Optional[str]]:
    return (getattr(_ACT_POLICY, "rules", None),
            getattr(_ACT_POLICY, "seq_axis", None))


def _constrain(x, spec, rules: MeshRules):
    """``x`` redistributed to ``spec`` on the policy's mesh."""
    if not isinstance(rules.mesh, DeviceMesh):
        raise ValueError("an activation policy over an {axis: size} "
                         "mapping cannot place tensors; give it a DeviceMesh")
    return redistribute(x, placements(spec, rules.mesh))


def constrain_hidden(x):
    """(B, S, d) hidden states: batch over the batch axes (the sequence
    for a batch that does not divide), optionally the sequence over the
    policy's ``seq_axis``."""
    rules, seq_axis = _policy()
    if rules is None or x.ndim != 3 or not isinstance(x, DTensor):
        return x
    ds = rules.batch_size_eff
    b, s, _ = x.shape
    if b % ds == 0:
        batch_s = rules.batch_spec()
        seq_s = seq_axis if (seq_axis and s % rules.sizes[seq_axis] == 0) \
            else None
    elif s % ds == 0:
        batch_s, seq_s = None, rules.batch_spec()
    else:
        batch_s, seq_s = None, None
    return _constrain(x, Spec(batch_s, seq_s, None), rules)


def constrain_logits(x):
    """(B, T, V) logit chunks: batch over the batch axes, vocabulary over
    the model axis."""
    rules, _ = _policy()
    if rules is None or x.ndim != 3 or not isinstance(x, DTensor):
        return x
    b, _, v = x.shape
    batch_s = rules.batch_spec() if b % rules.batch_size_eff == 0 else None
    vocab_s = (rules.model_axis if rules.tp_enabled
               and v % rules.model_size == 0 else None)
    return _constrain(x, Spec(batch_s, None, vocab_s), rules)
