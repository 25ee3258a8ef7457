"""Shape-and-dtype stand-ins for every (arch x shape) dry-run cell.

Counterpart of the reference's ``repro.launch.specs``.
``input_specs(arch, shape, rules)`` returns what a dry run of the cell
needs without allocating: the step callable, the arguments as
:class:`ShapeDtype` trees (shapes and dtypes, no tensors), and their
:class:`~repro_torch.distributed.sharding.Spec` trees under ``rules``
(a :class:`~repro_torch.distributed.sharding.MeshRules` over a
``DeviceMesh`` or an ``{axis: size}`` mapping, e.g.
``launch.mesh.make_rules(launch.mesh.axis_map(SINGLE_POD))``: no
process group of 256 or 512 ranks is needed).  Parameter shapes come
from ``init_params`` on the ``meta`` device.

The step callables are what one rank runs in the port's data-parallel
design (``training/train_step.py``: each parameter gathered whole, the
model run as plain tensors on the rank's batch shard):

  * train cells: the loss and its gradients (``train_step._grads``); the
    optimizer step is not run on stand-ins (its QR kernels need values)
    and is costed analytically by :mod:`repro_torch.launch.dryrun`;
  * prefill cells: ``forward_prefill``;
  * decode cells: ``serve_step`` at the cache's last position.

Prefill and decode cells take the fp32 parameters, as the port's
``ServeEngine`` does (the reference's take bf16 copies).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (MeshRules, Spec, batch_specs,
                                              cache_specs, map_with_names,
                                              param_specs, state_specs)

__all__ = ["ShapeDtype", "CellSpec", "input_specs", "cell_is_skipped",
           "train_microbatch", "materialize"]


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """The shape and dtype of one argument leaf (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class CellSpec:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    step_fn: Callable           # one rank's step on materialized arguments
    args: Tuple[Any, ...]       # ShapeDtype trees
    in_specs: Tuple[Any, ...]   # Spec trees (same structure)
    kind: str                   # "train" | "prefill" | "decode"
    rules: Any = None           # MeshRules actually used (variant may adjust)
    donate: Tuple[int, ...] = ()  # args a step updates in place
    out_specs: Any = None
    notes: str = ""


def cell_is_skipped(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention architecture: 500k-token decode needs "
                "sub-quadratic sequence mixing (DESIGN.md §7)")
    return None


def train_microbatch(cfg: ModelConfig, shape: ShapeConfig,
                     rules: MeshRules) -> int:
    """Global microbatch so one microbatch is ~1 sample per data shard for
    the big models (activation ceiling), larger for the small ones."""
    per_dev = 1 if cfg.d_model >= 2048 else 4
    return min(shape.global_batch, rules.data_size * per_dev)


def _stand_in(tree, dtype=None):
    """:class:`ShapeDtype` leaves of a tree of tensors (floating leaves
    cast to ``dtype`` when given)."""
    def leaf(_, t):
        if not isinstance(t, torch.Tensor):
            return t                       # a step count
        dt = dtype if dtype is not None and t.dtype.is_floating_point \
            else t.dtype
        return ShapeDtype(tuple(t.shape), dt)
    return map_with_names(leaf, tree)


def materialize(tree, device="meta"):
    """Tensors of the stand-ins' shapes and dtypes on ``device`` (the
    ``meta`` device: no storage)."""
    def leaf(_, s):
        if isinstance(s, ShapeDtype):
            return torch.empty(s.shape, dtype=s.dtype, device=device)
        return s
    return map_with_names(leaf, tree)


def _batch(cfg: ModelConfig, b: int, s: int, *, labels: bool) -> dict:
    out = {}
    if cfg.embedding_input:
        out["embeds"] = ShapeDtype((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = ShapeDtype((b, s), torch.int32)
    if labels:
        out["labels"] = ShapeDtype((b, s), torch.int32)
    return out


def _meta_params(cfg: ModelConfig):
    from repro_torch.launch.roofline import _meta_params

    return _meta_params(cfg)


def _cache_stand_ins(cfg: ModelConfig, b: int, s: int):
    """The decode caches' shapes and dtypes (``init_caches`` under a fake
    tensor mode: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import init_caches

    with FakeTensorMode():
        caches = init_caches(cfg, b, s, device="cpu")
    return _stand_in(caches)


_SMALL_MODEL_PARAMS = 4e9


def input_specs(arch: str, shape_name: str, rules: MeshRules,
                *, overrides: Optional[dict] = None,
                variant: str = "baseline") -> CellSpec:
    """``variant="optimized"`` applies the reference's beyond-paper
    bundle: causal block skipping, solve-based thin Q in the QR
    optimizer, once-per-step bf16 weight casts, and the no-TP / pure-DP
    sharding policy for sub-4B models."""
    from repro_torch.training.train_step import (TrainConfig, TrainState,
                                                 init_train_state)

    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    if variant.startswith("optimized"):
        cfg = cfg.scaled(attn_causal_skip=True)

    params = _meta_params(cfg)
    n_params = sum(p.numel() for _, p in params.named_parameters())
    if variant.startswith("optimized") and n_params < _SMALL_MODEL_PARAMS:
        all_axes = tuple(rules.sizes)
        rules = dataclasses.replace(rules, tp_enabled=False,
                                    batch_axes=all_axes)
    tree = params.tree()
    pspecs = param_specs(tree, rules)

    if shape.kind == "train":
        mb = train_microbatch(cfg, shape, rules)
        opt = variant.startswith("optimized")
        tcfg = TrainConfig(optimizer="muon-qr", microbatch=mb,
                           qr_q_method=("solve" if opt else "formq"),
                           cast_params_once=(variant == "optimized"),
                           qr_shard_leaves=(opt and "noshard" not in variant))
        state = init_train_state(params, tcfg)
        state_args = TrainState(params=_stand_in(tree),
                                opt=_stand_in(state.opt),
                                ef_error=_stand_in(state.ef_error))
        state_spec = TrainState(
            params=pspecs, opt=state_specs(tree, pspecs, state.opt, rules),
            ef_error=Spec())
        batch = _batch(cfg, shape.global_batch, shape.seq_len, labels=True)

        def step(state, batch, lr, _cfg=cfg, _tcfg=tcfg,
                 _b=shape.global_batch):
            """One rank's loss and gradients on its batch shard, in the
            global microbatch's share of it."""
            from repro_torch.models import ParamTree
            from repro_torch.training import train_step

            local = batch["labels"].shape[0]
            tc = dataclasses.replace(_tcfg, microbatch=max(
                1, _tcfg.microbatch * local // _b))
            return train_step._grads(ParamTree(state.params), batch, _cfg,
                                     tc)

        return CellSpec(arch, shape, cfg, step,
                        (state_args, batch, ShapeDtype((), torch.float32)),
                        (state_spec, batch_specs(batch, rules), Spec()),
                        "train", rules=rules, donate=(0,),
                        notes=f"microbatch={tcfg.microbatch};variant={variant}")

    # The port serves its fp32 masters (``dense`` casts each weight at use;
    # the recurrent mixers mix fp32 states with the weights as stored),
    # where the reference's serving cells take bf16 weights.
    serve_params = _stand_in(tree)

    if shape.kind == "prefill":
        batch = _batch(cfg, shape.global_batch, shape.seq_len, labels=False)

        def step(p, b, _cfg=cfg):
            from repro_torch.models import forward_prefill

            return forward_prefill(p, b, _cfg)

        return CellSpec(arch, shape, cfg, step, (serve_params, batch),
                        (pspecs, batch_specs(batch, rules)), "prefill",
                        rules=rules, notes=f"variant={variant}")

    # decode: one token against a full-length cache, at its last position
    caches = _cache_stand_ins(cfg, shape.global_batch, shape.seq_len)
    cspecs = cache_specs(caches, rules)
    tok = ShapeDtype((shape.global_batch, 1), torch.int32)

    def step(p, t, c, i, _cfg=cfg):
        from repro_torch.serving.engine import serve_step

        return serve_step(p, t, _cfg, c, i)

    return CellSpec(arch, shape, cfg, step,
                    (serve_params, tok, caches, shape.seq_len - 1),
                    (pspecs, batch_specs(tok, rules), cspecs, Spec()),
                    "decode", rules=rules, donate=(2,),
                    out_specs=(None, cspecs), notes=f"variant={variant}")
