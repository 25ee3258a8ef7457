"""Multi-pod dry run: cost every (arch x shape x mesh) cell without a card.

Counterpart of the reference's ``repro.launch.dryrun``, with its flags and
artifact keys (``status``, ``kind``, ``devices``, ``memory_analysis``,
``cost_analysis``, ``collectives``).  The reference lowers and compiles
each cell for 256 or 512 host devices and reads XLA's analyses; the port
has no compiler pass to ask, so each key has a source of its own, named
in the artifact's ``notes``:

  * ``cost_analysis.flops``: ``torch.utils.flop_counter.FlopCounterMode``
    over what one rank runs (:mod:`repro_torch.launch.specs`: the whole
    parameters, as the port's data-parallel step gathers them, and the
    rank's batch shard), on ``meta`` tensors — the matmul-class ops
    (mm, bmm, addmm, baddbmm, convolutions, attention); a train cell adds
    the QR-Muon optimizer's analytic FLOPs
    (``launch.roofline._qr_optimizer_flops``: every rank orthogonalizes
    every momentum whole);
  * ``memory_analysis``: ``argument_size_in_bytes`` from the shard shapes
    of the parameters, optimizer state, batch and caches under the
    cell's specs; ``gathered_parameter_bytes``, what the whole
    parameters add while a step holds them; ``temp_size_in_bytes``, the
    peak of live bytes a ``TorchDispatchMode`` counts over the meta run
    (each storage from the op that creates it to the death of the tensor
    that first holds it); ``peak_memory_in_bytes``, their sum;
  * ``collectives``: counted from the placements, as the port's step
    moves data (``training/train_step.py``): one all-gather of each
    sharded parameter a step (the whole tensor is its result), a
    reduce-scatter of each
    sharded gradient into its shard (an all-reduce where the parameter is
    replicated and the batch is sharded), QR-Muon's all-gather of each
    sharded momentum, two all-reduces of scalars (the metrics, the global
    norm), and an all-gather of a sequence-sharded batch.  The model runs
    on plain tensors, so the ``constrain_*`` activation constraints move
    nothing.  A step runs each once, so the weighted bytes equal the
    static ones.

A cell whose meta run needs a tensor's values says so: its
``cost_analysis`` then carries the analytic count
(``launch.roofline.analytic_cell_cost`` at the rank's batch) with
``source`` naming it, and ``temp_size_in_bytes`` is None.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--meshes both]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed.sharding import Spec, leaves_with_names
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, axis_map, make_rules
from repro_torch.launch.specs import (ShapeDtype, cell_is_skipped,
                                      input_specs, materialize)

__all__ = ["run_cell", "run_all", "main", "shard_bytes", "collective_counts",
           "LiveBytes"]

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
DEFAULT_OUT = os.path.join("build", "repro_torch_dryrun")


def _axes_size(entry, sizes: Mapping[str, int]) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    out = 1
    for n in names:
        out *= sizes[n]
    return out


def shard_bytes(leaf: ShapeDtype, spec, sizes: Mapping[str, int]) -> int:
    """Bytes of one rank's shard of ``leaf`` under ``spec`` (a dimension
    that does not divide keeps its ceiling, as a padded shard would)."""
    n = leaf.dtype.itemsize
    spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
    for d, e in zip(leaf.shape, spec):
        k = _axes_size(e, sizes)
        n *= -(-d // k)
    return n


def _sharded(spec) -> bool:
    return any(e is not None for e in spec)


def _pairs(args, specs):
    """``(names, ShapeDtype, Spec)`` of every leaf of ``args``."""
    spec_of = dict(leaves_with_names(specs))
    for names, leaf in leaves_with_names(args):
        if isinstance(leaf, ShapeDtype):
            spec = spec_of.get(names, Spec())
            yield names, leaf, spec if isinstance(spec, Spec) else Spec()


def collective_counts(cell) -> dict:
    """One rank's collectives a step, counted from the cell's placements
    (module docstring), in the reference's artifact keys."""
    sizes = cell.rules.sizes
    batch_shards = cell.rules.batch_size_eff
    bytes_ = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}

    def add(kind, n):
        bytes_[kind] += int(n)
        counts[kind] += 1

    params, pspecs = cell.args[0], cell.in_specs[0]
    if cell.kind == "train":
        params, pspecs = params.params, pspecs.params
    for names, leaf, spec in _pairs(params, pspecs):
        if _sharded(spec):
            add("all-gather", leaf.nbytes)
        if cell.kind != "train":
            continue
        if _sharded(spec):
            add("reduce-scatter", shard_bytes(leaf, spec, sizes))
        elif batch_shards > 1:
            add("all-reduce", leaf.nbytes)
        from repro_torch.optim.qr_muon import is_muon_param

        if _sharded(spec) and is_muon_param(
                names, torch.empty(leaf.shape, device="meta")):
            add("all-gather", leaf.nbytes)        # the momentum, whole
    if cell.kind == "train" and batch_shards > 1:
        add("all-reduce", 4 * 4)                  # loss, nll, aux, accuracy
        add("all-reduce", 4)                      # the global norm
    batch = cell.args[1]
    for _, leaf, spec in _pairs(batch, cell.in_specs[1]):
        if len(spec) >= 2 and spec[0] is None and _sharded(spec):
            add("all-gather", leaf.nbytes)        # a sequence-sharded batch
    total = sum(bytes_.values())
    return {"bytes": bytes_, "counts": counts, "total_bytes": total,
            "weighted_bytes": {k: float(v) for k, v in bytes_.items()},
            "total_weighted_bytes": float(total)}


class LiveBytes(TorchDispatchMode):
    """Counts the bytes of the storages the dispatched ops create while
    the tensors that first hold them live; ``peak`` is the largest sum.
    Storages of ``inputs`` are never counted."""

    def __init__(self, inputs=()):
        super().__init__()
        self.live = self.peak = 0
        self._seen = {t.untyped_storage()._cdata for t in inputs
                      if isinstance(t, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            self._seen.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, n)
        return out

    def _free(self, key, n):
        self.live -= n
        self._seen.discard(key)


def _local(cell):
    """What one rank runs on: the arguments with the whole parameters
    (gathered), the batch's dim 0 cut to the rank's shard when the batch
    shards it (else the whole batch, gathered), as ``meta`` tensors."""
    shards = cell.rules.batch_size_eff

    def cut_leaf(leaf, spec):
        shape = tuple(leaf.shape)
        if shape and spec and spec[0] is not None:
            shape = (shape[0] // shards,) + shape[1:]
        return ShapeDtype(shape, leaf.dtype)

    def cut(tree, specs):
        if isinstance(tree, ShapeDtype):            # decode's tokens
            return cut_leaf(tree, specs)
        return {k: cut_leaf(v, specs[k]) for k, v in tree.items()}

    args = list(cell.args)
    args[1] = cut(cell.args[1], cell.in_specs[1])
    if cell.kind == "decode":
        args[2] = _cut_caches(cell.args[2], cell.in_specs[2], shards)
    return [materialize(a) for a in args]


def _cut_caches(caches, specs, shards):
    """The decode caches of the rank's requests: dim 1 (batch, after the
    period axis) cut where the specs shard it, every head kept."""
    def cut(leaf, spec):
        shape = tuple(leaf.shape)
        if len(shape) >= 2 and len(spec) >= 2 and spec[1] is not None:
            shape = (shape[0], shape[1] // shards) + shape[2:]
        return ShapeDtype(shape, leaf.dtype)
    return tuple({k: cut(v, s[k]) for k, v in e.items()}
                 for e, s in zip(caches, specs))


def _analytic_flops(cell, local_batch: int) -> float:
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.roofline import analytic_cell_cost

    shape = ShapeConfig(cell.shape.name, cell.shape.seq_len, local_batch,
                        cell.kind)
    return analytic_cell_cost(cell.cfg, shape, cell.kind).flops


def _measure(cell) -> dict:
    """FLOPs, live bytes and the rank's batch of one meta run."""
    from torch.utils.flop_counter import FlopCounterMode

    args = _local(cell)
    local_batch = tree_leaves(args[1])[0].shape[0]
    inputs = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
    counter = FlopCounterMode(display=False)
    live = LiveBytes(inputs)
    try:
        with counter, live:
            cell.step_fn(*args)
    except (RuntimeError, NotImplementedError) as e:
        if "meta" not in str(e):        # not a value a meta run lacks
            raise
        return dict(local_batch=local_batch, flops=None, temp=None,
                    needs_values=f"{type(e).__name__}: {e}"[:300])
    return dict(local_batch=local_batch, flops=float(
        counter.get_total_flops()), temp=int(live.peak))


def _memory(cell, temp: Optional[int]) -> dict:
    sizes = cell.rules.sizes
    args = sum(shard_bytes(leaf, spec, sizes)
               for a, s in zip(cell.args, cell.in_specs)
               for _, leaf, spec in _pairs(a, s))
    params, pspecs = cell.args[0], cell.in_specs[0]
    if cell.kind == "train":
        params, pspecs = params.params, pspecs.params
    gathered = sum(leaf.nbytes - shard_bytes(leaf, spec, sizes)
                   for _, leaf, spec in _pairs(params, pspecs))
    return {"argument_size_in_bytes": int(args),
            "gathered_parameter_bytes": int(gathered),
            "temp_size_in_bytes": temp,
            "peak_memory_in_bytes": (None if temp is None
                                     else int(args + gathered + temp))}


def _notes(cell, measured: bool) -> str:
    flops = ("FlopCounterMode over one rank's step on meta tensors "
             "(matmul-class ops)" if measured else
             "analytic (launch.roofline.analytic_cell_cost at the rank's "
             "batch): the meta run needs tensor values")
    if cell.kind == "train":
        flops += " + the QR-Muon optimizer's analytic FLOPs"
    return (f"{cell.notes};cost_analysis.flops: {flops};"
            f"memory_analysis: argument bytes from the shard shapes under "
            f"the cell's specs, temp bytes "
            f"{'a TorchDispatchMode peak of live bytes over the meta run' if measured else 'not measured'};"
            f"collectives: counted from the placements (one all-gather of "
            f"each sharded parameter a step, gradients reduce-scattered)")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             save_hlo: bool = False, variant: str = "baseline", *,
             axes: Optional[Mapping[str, int]] = None,
             overrides: Optional[dict] = None) -> dict:
    """Cost one cell and write its artifact.  ``axes`` replaces the
    production mesh by an ``{axis: size}`` map (its name ``d2xm4``...);
    ``overrides`` reconfigures the model (a reduced cell).
    ``save_hlo`` is the reference's flag; the port has no HLO and
    ignores it."""
    if axes is None:
        axes = axis_map(MULTI_POD if multi_pod else SINGLE_POD)
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "x".join(f"{k[0]}{v}" for k, v in axes.items())
    if variant != "baseline":
        mesh_name += f"__{variant}"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "variant": variant, "status": "unknown"}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        record.update(status="skipped", reason=skip)
        return _write(record, out_dir)

    t0 = time.time()
    try:
        rules = make_rules(dict(axes))
        cell = input_specs(arch, shape_name, rules, overrides=overrides,
                           variant=variant)
        t_spec = time.time() - t0
        got = _measure(cell)
        measured = got["flops"] is not None
        if measured:
            flops = got["flops"]
            source = "FlopCounterMode (meta run)"
        else:
            flops = _analytic_flops(cell, got["local_batch"])
            source = f"analytic: the meta run needs values ({got['needs_values']})"
        cost = {"flops": flops, "source": source}
        if cell.kind == "train":
            from repro_torch.launch.roofline import _qr_optimizer_flops

            qr = _qr_optimizer_flops(cell.cfg)
            cost.update(model_flops_measured=got["flops"],
                        qr_optimizer_flops=qr)
            if measured:
                cost["flops"] = flops + qr
        mem = _memory(cell, got["temp"])
        coll = collective_counts(cell)
        print(f"[{arch} {shape_name} {mesh_name}] memory_analysis:",
              {k: f"{v / 2 ** 30:.3f}GiB" for k, v in mem.items()
               if isinstance(v, int)})
        print(f"[{arch} {shape_name} {mesh_name}] cost_analysis flops:",
              cost["flops"])
        record.update(
            status="ok", kind=cell.kind, notes=_notes(cell, measured),
            lower_s=round(t_spec, 2), compile_s=round(time.time() - t0
                                                      - t_spec, 2),
            devices=_prod(axes.values()),
            local_batch=got["local_batch"], memory_analysis=mem,
            cost_analysis=cost, collectives=coll)
    except Exception as e:
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    return _write(record, out_dir)


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _write(record: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{record['arch']}__{record['shape']}__{record['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(record, f, indent=1)
    status = record["status"]
    extra = record.get("reason", record.get("error", ""))
    print(f"[dryrun] {record['arch']} x {record['shape']} x {record['mesh']}"
          f" -> {status} {extra[:200]}")
    return record


def run_all(out_dir: str, meshes: list, archs=None, shapes=None,
            jobs: int = 1) -> int:
    """One subprocess per cell (each meta run's memory goes with it)."""
    cells = [(a, s, mp) for a in (archs or ARCHS) for s in (shapes or SHAPES)
             for mp in meshes]
    failures = 0
    running = []
    for (arch, shape, mp) in cells:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out_dir]
        if mp:
            cmd.append("--multi-pod")
        running.append(((arch, shape, mp), subprocess.Popen(cmd)))
        while len(running) >= jobs:
            done = [(c, p) for c, p in running if p.poll() is not None]
            if not done:
                time.sleep(0.5)
                continue
            for c, p in done:
                running.remove((c, p))
                if p.returncode != 0:
                    failures += 1
                    print(f"[dryrun] SUBPROCESS FAILED: {c}")
    for c, p in running:
        if p.wait() != 0:
            failures += 1
            print(f"[dryrun] SUBPROCESS FAILED: {c}")
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--meshes", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--save-hlo", action="store_true",
                    help="the reference's flag; the port has no HLO")
    ap.add_argument("--variant", default="baseline",
                    choices=["baseline", "optimized", "optimized_nocast",
                             "optimized_noshard"])
    args = ap.parse_args(argv)

    if args.all:
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.meshes]
        sys.exit(1 if run_all(args.out, meshes, jobs=args.jobs) else 0)

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                   save_hlo=args.save_hlo, variant=args.variant)
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
