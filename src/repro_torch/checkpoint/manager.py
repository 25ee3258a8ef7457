"""Checkpointing: atomic, asynchronous, restored onto any device.

Counterpart of the reference's ``repro.checkpoint.manager``, with the
same on-disk layout, so either package reads the other's checkpoints:

    <root>/step_00001234/
        manifest.json      # step, user metadata, each leaf's keypath,
                           #   shape and dtype
        arr_00000.npy ...  # the leaves, in tree order
        COMMITTED          # written last; directories without it are
                           #   ignored

A tree is a tensor (or a Python number or numpy array), or a dict,
tuple, list or NamedTuple of trees; ``None`` holds no leaf.  Leaves are
ordered and named as ``jax.tree_util`` orders them and as its ``keystr``
prints their paths: dict keys sorted (``['key']``), sequence positions
(``[0]``), NamedTuple fields (``.field``).

Guarantees the trainer relies on:
  * atomicity — a save writes ``.tmp-<step>``, renames it with
    ``os.replace`` and then writes ``COMMITTED``, so a crash mid-save
    never damages the latest checkpoint;
  * asynchrony — ``save(..., blocking=False)`` copies every leaf to host
    memory before it returns and writes the files on a background thread.
    The copy is taken before the return because the port's train step
    updates parameters in place (the reference's arrays are immutable, so
    its copy can wait for the thread);
  * placement on restore — each leaf is loaded onto the example leaf's
    device and dtype;
  * meshes — a DTensor leaf is saved whole: every rank gathers it (the
    ranks call ``save`` together, in the same order), group rank 0 of the
    default process group writes, and the other ranks wait for its
    commit in :meth:`CheckpointManager.wait_until_finished` (a barrier).
    A DTensor example leaf restores into its own placements, each rank
    keeping its shard of the whole tensor, so a run saved on one mesh
    resumes on another.  A tree without DTensors is saved and restored
    as before, on every rank that calls.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import full_tensor, shard_like

__all__ = ["CheckpointManager"]


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util``'s flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves_with_path(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree``'s structure holding ``leaves`` (taken in flatten order)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _host_copy(x: Any) -> np.ndarray:
    """A numpy copy of one leaf that no later write to ``x`` reaches (a
    DTensor gathered whole first: a collective)."""
    if isinstance(x, DTensor):
        x = full_tensor(x)
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _shape(x: Any) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _place(arr: np.ndarray, example: Any) -> Any:
    """``arr`` as the example leaf's kind: a tensor on its device and
    dtype, a Python number of its type, or a numpy array."""
    if isinstance(example, DTensor):
        whole = torch.from_numpy(arr).to(device=example.device,
                                         dtype=example.dtype)
        return shard_like(whole, example)
    if isinstance(example, torch.Tensor):
        return torch.from_numpy(arr).to(device=example.device,
                                        dtype=example.dtype)
    if isinstance(example, (bool, int, float)):
        return type(example)(arr.item())
    return arr


class CheckpointManager:
    def __init__(self, root: str, *, keep_n: int = 3):
        self.root = root
        self.keep_n = keep_n
        os.makedirs(root, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending: Optional[Future] = None
        self._lock = threading.Lock()
        self._shared_pending = False    # a mesh save awaiting its barrier

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    # ------------------------------------------------------------- write

    def save(self, step: int, tree: Any, *, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        """Snapshot ``tree`` at ``step``.  The host copy is taken before
        this returns; with ``blocking=False`` the files are written on the
        background thread (:meth:`wait_until_finished` waits for them and
        raises what the write raised)."""
        self.wait_until_finished()
        leaves = list(_leaves_with_path(tree))
        shared = any(isinstance(x, DTensor) for _, x in leaves)
        host: List[Tuple[str, np.ndarray]] = [
            (kp, _host_copy(x)) for kp, x in leaves]
        meta = dict(metadata or {})
        if shared:
            self._shared_pending = True
            if dist.get_rank() != 0:
                if blocking:
                    self.wait_until_finished()
                return

        def write():
            tmp = os.path.join(self.root, f".tmp-{step}")
            final = self._dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "metadata": meta, "leaves": []}
            for i, (kp, arr) in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
                manifest["leaves"].append(
                    {"keypath": kp, "shape": list(arr.shape),
                     "dtype": str(arr.dtype)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            with open(os.path.join(final, "COMMITTED"), "w") as f:
                f.write("ok\n")
            self._gc()

        if blocking:
            write()
            if shared:
                self.wait_until_finished()
        else:
            with self._lock:
                self._pending = self._pool.submit(write)

    def wait_until_finished(self) -> None:
        """Wait for the last save's files (and raise what the write
        raised); after a save of DTensors, every rank waits here until
        the writer has committed."""
        with self._lock:
            pending = self._pending
            self._pending = None
        if pending is not None:
            pending.result()
        if self._shared_pending:
            self._shared_pending = False
            dist.barrier()

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep_n]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -------------------------------------------------------------- read

    def all_steps(self) -> list:
        """Committed steps, ascending (a directory without ``COMMITTED``
        is a save that did not finish)."""
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.root, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metadata(self, step: int) -> dict:
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            return json.load(f)["metadata"]

    def restore(self, step: int, example: Any) -> Any:
        """The checkpoint at ``step`` in ``example``'s structure, each leaf
        on the example leaf's device and dtype.  Raises ``ValueError``
        when the structure (leaf count or keypaths) or a shape differs."""
        d = self._dir(step)
        if not os.path.exists(os.path.join(d, "COMMITTED")):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        with open(os.path.join(d, "manifest.json")) as f:
            entries = json.load(f)["leaves"]
        leaves = list(_leaves_with_path(example))
        if len(leaves) != len(entries):
            raise ValueError(f"checkpoint has {len(entries)} leaves, "
                             f"target expects {len(leaves)}")
        restored = []
        for i, ((kp, ex), entry) in enumerate(zip(leaves, entries)):
            if kp != entry["keypath"]:
                raise ValueError(f"leaf {i} keypath mismatch: "
                                 f"{entry['keypath']} vs {kp}")
            arr = np.load(os.path.join(d, f"arr_{i:05d}.npy"))
            if tuple(arr.shape) != _shape(ex):
                raise ValueError(f"leaf {kp}: shape {arr.shape} vs target "
                                 f"{_shape(ex)}")
            restored.append(_place(arr, ex))
        return _rebuild(example, iter(restored))
