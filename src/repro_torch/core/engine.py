"""Wavefront macro-op engine: the levelized tile DAG executed level by
level over a ``(p, q, nb, nb)`` tile workspace.

Counterpart of the reference's ``repro.core.engine``.  The schedule
functions (:func:`wavefront_task_arrays`, :func:`task_count`,
:func:`megakernel_task_table`, :func:`table_fits`,
:func:`explain_dispatch_mode`, :func:`resolve_dispatch_mode`,
:func:`modeled_dma_bytes`, :func:`schedule_stats`) are numpy only and
equal the reference's integer for integer.

Three lowerings run the schedule:

  * the **wavefront kernel lowering** (``use_kernel=True``,
    ``dispatch_mode="wavefront"``): every wavefront's same-kind task batch
    is one launch of a hand-written CUDA kernel
    (:mod:`repro_torch.kernels.macro_ops`), in the canonical kind order
    GEQRT, LARFB, TSQRT, SSRFB on one stream; on a ``(B, p, q, nb, nb)``
    stack one launch per (level, kind) runs that batch on every slice, so a
    stack takes one schedule's launches whatever B;
  * the **megakernel lowering** (``use_kernel=True``,
    ``dispatch_mode="megakernel"``): one cooperative launch walks the
    whole task table (:func:`megakernel_task_table`), each CTA a
    contiguous run of every level (:func:`megakernel_runs`), a grid
    barrier between levels; :func:`factor_tiles_batched` runs a whole
    ``(B, p, q, nb, nb)`` stack through one launch of its batched twin.
    It calls the wavefront kernels' compute functions, so the two kernel
    lowerings agree bit for bit;
  * the **plain lowering** (``use_kernel=False``): the wavefront batches
    through the kernels' plain PyTorch versions (on a stack, each batch
    over all its slices at once, as the wavefront kernels run it).

Q formation (:func:`form_q_tiles`) runs the factorization's updates in
reverse over a second tile workspace E (:func:`q_task_arrays`,
:func:`q_megakernel_task_table`) by the same lowering: the Q kinds of the
wavefront walk, or one (batched) megakernel launch over the Q table.

``dispatch_mode=None`` resolves by the reference's auto rule
(:func:`resolve_dispatch_mode`): megakernel when the task table fits
:data:`DEFAULT_TABLE_BUDGET` and the reference's modeled working set fits
:data:`DEFAULT_SMEM_BUDGET`; a forced megakernel whose table does not fit
raises.  Every lowering updates the workspace **in place** — the caller's
tensor is consumed and becomes the factored tiles (pass a clone to keep
it), the counterpart of the reference's buffer donation.  The per-level
``(k, i, j)`` index arrays and the task table are uploaded to the
workspace's device once per ``(p, q)`` and cached there, so a
factorization makes no host-to-device copies of them.

Instrumentation, as the reference places it: each factor call adds to the
``engine.*`` metric series (:func:`_emit_factor_metrics`; the ``phase``
label is always "execute": the port counts every call) and runs inside an
``engine.factor_tiles`` / ``engine.factor_tiles_batched`` span; each
wavefront batch and each megakernel launch runs inside a profiler range
(``geqrt@L3``, ``megakernel[16x16]``) while annotations are on; and
:func:`_check_dispatch` carries the fault harness's ``vmem`` site.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import macro_ops
from repro_torch.observability import metrics as _metrics
from repro_torch.observability import profiler as _profiler
from repro_torch.observability import trace as _trace
from repro_torch.robustness import inject as _inject

__all__ = [
    "DEFAULT_SMEM_BUDGET",
    "DEFAULT_TABLE_BUDGET",
    "DISPATCH_MODES",
    "FactorState",
    "check_smem",
    "check_table",
    "dispatch_counts",
    "explain_dispatch_mode",
    "factor_tiles",
    "factor_tiles_batched",
    "form_q_tiles",
    "init_state",
    "level_indices",
    "megakernel_runs",
    "megakernel_runs_device",
    "megakernel_table",
    "megakernel_task_table",
    "modeled_dma_bytes",
    "prepare_dispatch",
    "q_dispatch_counts",
    "q_level_indices",
    "q_megakernel_runs",
    "q_megakernel_table",
    "q_megakernel_task_table",
    "q_table_fits",
    "q_task_arrays",
    "q_task_count",
    "q_workspace",
    "resolve_dispatch_mode",
    "resolve_q_dispatch_mode",
    "run_q_levels",
    "run_levels",
    "schedule_stats",
    "state_from_numpy",
    "state_to_numpy",
    "table_fits",
    "task_count",
    "wavefront_task_arrays",
]

# The canonical kind order; a kind's table id is its index here.
_KIND_ORDER = tuple(macro_ops.MACRO_OPS)

#: The kernel lowerings of the schedule (see the module doc).
DISPATCH_MODES = ("wavefront", "megakernel")

#: Shared memory one H100 thread block can use (227 KB): the budget of a
#: task's working set on the kernel path.
DEFAULT_SMEM_BUDGET = 232_448

#: Task-table budget of the megakernel auto rule, kept at the reference's
#: 512 KiB so that the rule resolves the same way.
DEFAULT_TABLE_BUDGET = 512 * 1024


class FactorState(NamedTuple):
    """Factored tile state: packed reflectors + per-task block reflectors.

    tiles:  (p, q, nb, nb) — diagonal tiles hold V1 strictly below / R on
            and above the diagonal; tiles (i, k), i > k hold the TSQRT V2;
            tiles (k, j), j > k hold R blocks.
    d_t:    (r, nb, nb) GEQRT block reflectors T;  d_taus: (r, nb)
    t_t:    (p, r, nb, nb) TSQRT block reflectors; t_taus: (p, r, nb)
    """

    tiles: torch.Tensor
    d_t: torch.Tensor
    d_taus: torch.Tensor
    t_t: torch.Tensor
    t_taus: torch.Tensor


def state_from_numpy(arrays, device=None) -> FactorState:
    """A :class:`FactorState` from five numpy arrays in the reference's
    layout (a ``repro.core.engine.FactorState`` converted field by field
    with ``np.asarray``), on ``device``."""
    return FactorState(*(torch.as_tensor(np.array(x), device=device)
                         for x in arrays))


def state_to_numpy(state: FactorState) -> Tuple[np.ndarray, ...]:
    """The five state arrays as numpy, in the reference's layout."""
    return tuple(x.detach().cpu().numpy() for x in state)


# ---------------------------------------------------------------------------
# the static schedule (numpy; equal to the reference's)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def wavefront_task_arrays(p: int, q: int
                          ) -> Tuple[Dict[str, np.ndarray], ...]:
    """The static schedule as dispatchable batches: one dict per
    wavefront mapping kind -> int32 ``(ntasks, 3)`` array of (k, i, j)."""
    from repro_torch.core.tilegraph import wavefronts  # tilegraph imports us

    out: List[Dict[str, np.ndarray]] = []
    for wf in wavefronts(p, q):
        by_kind: Dict[str, List] = {}
        for t in wf:
            by_kind.setdefault(t.kind, []).append(t)
        out.append({kind: np.array([[t.k, t.i, t.j] for t in tasks],
                                   dtype=np.int32)
                    for kind, tasks in by_kind.items()})
    return tuple(out)


_KIND_ID = {kind: n for n, kind in enumerate(_KIND_ORDER)}
_NOOP = macro_ops.NOOP

_COL_KIND, _COL_K, _COL_I, _COL_J = 0, 1, 2, 3
_COL_R0 = 4            # 3 (row, col) operand-tile coords: columns 4..9
_COL_FETCHED = 10      # operands already streaming (predecessor prefetch)
_COL_PREFETCH = 11     # this slot prefetches the successor's operands
_COL_REUSE0 = 12       # per-operand buffer-reuse flags: columns 12..14
_COL_REUSET = 15       # block-reflector (T) operand reuse flag
_NCOLS = macro_ops.TABLE_COLS


def _task_reads(kind: str, k: int, i: int, j: int) -> List[Tuple[int, int]]:
    """Ordered workspace tiles a task reads (matches the body args)."""
    if kind == "GEQRT":
        return [(k, k)]
    if kind == "LARFB":
        return [(k, k), (k, j)]
    if kind == "TSQRT":
        return [(k, k), (i, k)]
    return [(i, k), (k, j), (i, j)]  # SSRFB


def _task_writes(kind: str, k: int, i: int, j: int) -> set:
    """Workspace tiles a task writes."""
    if kind == "GEQRT":
        return {(k, k)}
    if kind == "LARFB":
        return {(k, j)}
    if kind == "TSQRT":
        return {(k, k), (i, k)}
    return {(k, j), (i, j)}  # SSRFB


def _task_t_source(kind: str, k: int, i: int, j: int):
    """Identity of the block-reflector (T) operand, or None."""
    if kind == "LARFB":
        return ("d_t", k)
    if kind == "SSRFB":
        return ("t_t", i, k)
    return None


def task_count(p: int, q: int) -> int:
    """Closed-form DAG size: step k contributes (p - k)(q - k) tasks."""
    return sum((p - k) * (q - k) for k in range(min(p, q)))


def _fill_table(levels, kind_id, reads, writes, t_source
                ) -> Tuple[np.ndarray, int, int]:
    """A task table from ``levels`` (per level, its ``(kind, k, i, j)``
    tasks in slot order): the kind ids, the tasks' operand tiles and the
    one-ahead prefetch and reuse chains.  ``reads`` lists a task's operand
    tiles in body order and ``writes`` the tiles it writes, each tile a
    tuple ending in (row, col) — a tag ahead of them names the workspace
    where there are two — and ``t_source`` names its block reflector.
    Asserts that no two tasks of a level write the same tile and that a
    slot's successor never reads what the slot writes."""
    nlevels = len(levels)
    nslots = max(len(rows) for rows in levels)
    tab = np.zeros((nlevels * nslots, _NCOLS), np.int32)
    tab[:, _COL_KIND] = _NOOP
    for lv, rows in enumerate(levels):
        written = [w for task in rows for w in writes(*task)]
        assert len(written) == len(set(written)), "same-level write overlap"
        for s, task in enumerate(rows):
            kind, k, i, j = task
            t = lv * nslots + s
            tab[t, _COL_KIND] = kind_id[kind]
            tab[t, _COL_K], tab[t, _COL_I], tab[t, _COL_J] = k, i, j
            for b, tile in enumerate(reads(*task)):
                tab[t, _COL_R0 + 2 * b] = tile[-2]
                tab[t, _COL_R0 + 2 * b + 1] = tile[-1]
        for s in range(len(rows) - 1):
            cur, nxt = rows[s], rows[s + 1]
            t = lv * nslots + s
            nr = reads(*nxt)
            assert not (set(nr) & writes(*cur)), (cur, nxt)
            tab[t, _COL_PREFETCH] = 1
            tab[t + 1, _COL_FETCHED] = 1
            cr = reads(*cur)
            for b in range(min(len(cr), len(nr))):
                if nr[b] == cr[b]:
                    tab[t + 1, _COL_REUSE0 + b] = 1
            cts = t_source(*cur)
            if cts is not None and cts == t_source(*nxt):
                tab[t + 1, _COL_REUSET] = 1
    return tab, nlevels, nslots


@functools.lru_cache(maxsize=None)
def megakernel_task_table(p: int, q: int) -> Tuple[np.ndarray, int, int]:
    """The flattened schedule ``(table, nlevels, nslots)`` of the
    reference's megakernel lowering: an int32 ``(nlevels * nslots, 16)``
    array, one row per (level, slot), with the prefetch and reuse chains
    of its one-ahead double buffering.  Asserts the two invariants those
    rely on: no two same-level tasks write the same tile, and a slot's
    successor never reads what the slot writes."""
    levels = [[(kind, int(k), int(i), int(j))
               for kind in _KIND_ORDER
               for k, i, j in by_kind.get(kind, ())]
              for by_kind in wavefront_task_arrays(p, q)]
    return _fill_table(levels, _KIND_ID, _task_reads, _task_writes,
                       _task_t_source)


# ---------------------------------------------------------------------------
# Q formation's schedule (numpy): the factorization's updates in reverse
# ---------------------------------------------------------------------------
#
# Q's first ncols columns form in a (p, qe, nb, nb) tile workspace E,
# qe = ncols / nb, starting from the identity, by the tasks
#
#     QSSRFB(k, i, j)  E_k, E_i <- E_k - W, E_i - V2 W,
#                      W = T_ik (E_k + V2^T E_i)        (tiles (k, j), (i, j))
#     QLARFB(k, j)     E_k <- E_k - V1 (D_k (V1^T E_k))  (tile (k, j))
#
# in the sequential order of tilegraph._form_q_tiled: k descending, and
# within k, i descending, then the diagonal step.  A task's level is 1 +
# the highest level of any E tile it touches, in that order.  Column tiles
# j < k are skipped: E's rows >= k are still exactly zero there (E starts
# as the identity and every later step touches rows >= k + 1 only), so the
# update would be an exact no-op — LAPACK's orgqr skips it the same way.

#: Q formation's kinds, in their canonical order within a level.
Q_KINDS = tuple(macro_ops.Q_OPS)


def _q_task_reads(kind: str, k: int, i: int, j: int) -> List[Tuple]:
    """Operand tiles of a Q task in body order: the factored V tile, then
    E's tiles (tagged with their workspace)."""
    if kind == "QLARFB":
        return [("v", k, k), ("e", k, j)]
    return [("v", i, k), ("e", k, j), ("e", i, j)]


def _q_task_writes(kind: str, k: int, i: int, j: int) -> set:
    if kind == "QLARFB":
        return {("e", k, j)}
    return {("e", k, j), ("e", i, j)}


def _q_task_t_source(kind: str, k: int, i: int, j: int):
    return ("d_t", k) if kind == "QLARFB" else ("t_t", i, k)


def q_task_count(p: int, q: int, qe: int) -> int:
    """Q formation's task count: step k updates columns k..qe - 1 of its
    p - k row tiles (p - k - 1 QSSRFB and one QLARFB each)."""
    return sum((p - k) * max(qe - k, 0) for k in range(min(p, q)))


@functools.lru_cache(maxsize=None)
def q_task_arrays(p: int, q: int, qe: int
                  ) -> Tuple[Dict[str, np.ndarray], ...]:
    """Q formation's schedule as dispatchable batches: one dict per level
    mapping kind -> int32 ``(ntasks, 3)`` array of (k, i, j) (QLARFB: i =
    k), sorted by (k, i, j) so that a same-(k, i) group is contiguous.
    Asserts that no two tasks of a level write the same E tile."""
    last = np.zeros((p, qe), np.int64)   # level of the last toucher
    parts = []
    for k in reversed(range(min(p, q))):
        if k >= qe:
            continue
        js = np.arange(k, qe)
        col = np.ones_like(js)
        for i in reversed(range(k + 1, p)):
            lv = 1 + np.maximum(last[k, k:], last[i, k:])
            last[k, k:] = lv
            last[i, k:] = lv
            parts.append(np.stack([lv, col, col * k, col * i, js], 1))
        lv = 1 + last[k, k:]
        last[k, k:] = lv
        parts.append(np.stack([lv, 0 * col, col * k, col * k, js], 1))
    if not parts:
        return ()
    rows = np.concatenate(parts)
    rows = rows[np.lexsort(rows.T[::-1])]   # by level, kind, k, i, j
    out = []
    for lv in range(1, int(rows[-1, 0]) + 1):
        at = rows[rows[:, 0] == lv]
        level = {kind: at[at[:, 1] == n][:, 2:].astype(np.int32)
                 for n, kind in enumerate(Q_KINDS) if (at[:, 1] == n).any()}
        written = [w for kind, idx in level.items()
                   for k, i, j in idx.tolist()
                   for w in _q_task_writes(kind, k, i, j)]
        assert len(written) == len(set(written)), "same-level write overlap"
        out.append(level)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def q_megakernel_task_table(p: int, q: int, qe: int
                            ) -> Tuple[np.ndarray, int, int]:
    """Q formation's schedule as a megakernel task table ``(table,
    nlevels, nslots)``, in :func:`megakernel_task_table`'s format with the
    kinds ``macro_ops.Q_KIND_ID``; the same two invariants asserted."""
    levels = [[(kind, int(k), int(i), int(j))
               for kind in Q_KINDS
               for k, i, j in by_kind.get(kind, ())]
              for by_kind in q_task_arrays(p, q, qe)]
    return _fill_table(levels, macro_ops.Q_KIND_ID, _q_task_reads,
                       _q_task_writes, _q_task_t_source)


_UPDATE_IDS = (_KIND_ID["LARFB"], _KIND_ID["SSRFB"],
               macro_ops.Q_KIND_ID["QLARFB"], macro_ops.Q_KIND_ID["QSSRFB"])


def _chained(rows: np.ndarray) -> np.ndarray:
    """``chained[t]``: task t of a level (rows in table order) continues
    the run of t - 1 in a way the megakernel keeps a tile for — an update
    (LARFB, SSRFB, QLARFB, QSSRFB) after one of its own kind whose V
    operand the REUSE0 column marks as the same tile (a same-k LARFB or a
    same-(k, i) SSRFB group)."""
    kind = rows[:, _COL_KIND]
    out = np.zeros(len(rows), bool)
    out[1:] = ((kind[1:] == kind[:-1])
               & np.isin(kind[1:], _UPDATE_IDS)
               & (rows[1:, _COL_REUSE0] != 0))
    return out


#: Weight of a GEQRT or TSQRT task against a LARFB or SSRFB (1) when the
#: megakernel's runs balance a level over the CTAs: a GEQRT/TSQRT is a
#: chain of nb dependent column steps (~20 us alone, PERF.md §6), where an
#: SSRFB's throughput cost on a shared SM is a few us; counted as one, two
#: or three of them would land on one CTA and set the level's time.  6 was
#: the best of 1, 4, 6, 8, 10, 12 and 16 on the (60, 576, 576) stack
#: (chip_smoke.py's stack on an H100; PERF.md §6).
HEAVY_TASK_WEIGHT = 6


def _task_weights(rows: np.ndarray) -> np.ndarray:
    heavy = np.isin(rows[:, _COL_KIND], (_KIND_ID["GEQRT"], _KIND_ID["TSQRT"]))
    return np.where(heavy, HEAVY_TASK_WEIGHT, 1)


@functools.lru_cache(maxsize=None)
def megakernel_runs(p: int, q: int, batch: int, grid: int) -> np.ndarray:
    """The megakernel's runs: an int32 ``(nlevels, grid, 8)`` array whose
    ``[lv, c]`` is ``(start, end, n, slot, kind, k, i, j)``: ``[start,
    end)`` is CTA c's contiguous run of level lv's work list, the level's
    n tasks of slice 0, then of slice 1, ... (item ``w`` is slice ``w //
    n``, task ``w % n``), ``slot = start % n`` the table row of the run's
    first task and ``(kind, k, i, j)`` that row's task (what the kernel
    reads a level ahead instead of scanning the table).

    The runs cover every item exactly once, in order.  A level of at most
    ``grid`` items gives each of the first CTAs one.  Otherwise boundary c
    starts at the first item whose preceding items weigh at least c / grid
    of the level (:func:`_task_weights`), and moves to the nearest end of a
    chained group (:func:`_chained`) that it falls inside, where that end
    is at most a sixteenth of an even run away: a split group costs its
    second CTA one reload of the V tile and T, a longer run costs whole
    tasks.  A CTA's run may span slices; the kernel keeps no tile across a
    slice boundary."""
    return _runs(*megakernel_task_table(p, q), batch, grid)


@functools.lru_cache(maxsize=None)
def q_megakernel_runs(p: int, q: int, qe: int, batch: int, grid: int
                      ) -> np.ndarray:
    """:func:`megakernel_runs` of Q formation's table
    (:func:`q_megakernel_task_table`).  A Q level holds two tasks that
    share V and T only where Q has more column tiles than the factored
    grid (qe > q, full Q of a tall matrix): a same-(k, i) QSSRFB group or
    a same-k QLARFB group is then kept on one CTA as the factorization's
    groups are.  With qe <= q a task's level rises with j for a fixed (k,
    i) or k, so no level holds such a group."""
    return _runs(*q_megakernel_task_table(p, q, qe), batch, grid)


def _runs(table: np.ndarray, nlevels: int, nslots: int, batch: int,
          grid: int) -> np.ndarray:
    out = np.zeros((nlevels, grid, 8), np.int32)
    counts = []
    for lv in range(nlevels):
        rows = table[lv * nslots:(lv + 1) * nslots]
        n = int((rows[:, _COL_KIND] != _NOOP).sum())
        counts.append(n)
        chained = _chained(rows[:n])
        total = batch * n
        if total <= grid:  # a task a CTA: the level takes its slowest task
            out[lv, :total, 0] = np.arange(total)
            out[lv, :total, 1] = np.arange(1, total + 1)
            out[lv, total:] = total
            continue
        # before[x]: the weight of the items ahead of item x.
        before = np.concatenate(
            [[0], np.cumsum(np.tile(_task_weights(rows[:n]), batch))])
        targets = np.arange(1, grid) * before[-1] / grid
        slack = total // grid // 16
        bounds = [0]
        for x in np.searchsorted(before, targets, side="left").tolist():
            x = min(x, total)
            b, t = divmod(x, n)
            if x < total and chained[t] and slack:
                g0 = t
                while chained[g0]:
                    g0 -= 1
                g1 = t
                while g1 < n and chained[g1]:
                    g1 += 1
                if min(t - g0, g1 - t) <= slack:
                    x = b * n + (g0 if t - g0 <= g1 - t else g1)
            bounds.append(max(x, bounds[-1]))
        bounds.append(total)
        out[lv, :, 0] = bounds[:-1]
        out[lv, :, 1] = bounds[1:]
    n = np.asarray(counts, np.int32)[:, None]
    out[:, :, 2] = n
    out[:, :, 3] = out[:, :, 0] % n
    out[:, :, 4:8] = table[np.arange(nlevels)[:, None] * nslots
                           + out[:, :, 3], :4]
    return out


_DEVICE_RUNS: Dict[Tuple, torch.Tensor] = {}


def megakernel_runs_device(p: int, q: int, batch: int, grid: int,
                           device: torch.device, qe: Optional[int] = None
                           ) -> torch.Tensor:
    """:func:`megakernel_runs` (:func:`q_megakernel_runs` when ``qe`` is
    given) on ``device``: one upload per key."""
    key = (p, q, qe, batch, grid, str(device))
    if key not in _DEVICE_RUNS:
        runs = (megakernel_runs(p, q, batch, grid) if qe is None
                else q_megakernel_runs(p, q, qe, batch, grid))
        _DEVICE_RUNS[key] = torch.from_numpy(runs).to(device)
    return _DEVICE_RUNS[key]


def table_fits(p: int, q: int, budget: int) -> Tuple[bool, int]:
    """Does the ``(p, q)`` task table fit ``budget`` bytes?  ``(fits,
    bytes)``; the closed-form lower bound rejects big grids unlevelized."""
    bound = task_count(p, q) * _NCOLS * 4
    if bound > budget:
        return False, bound
    nbytes = int(megakernel_task_table(p, q)[0].nbytes)
    return nbytes <= budget, nbytes


def q_table_fits(p: int, q: int, qe: int, budget: int) -> Tuple[bool, int]:
    """:func:`table_fits` for Q formation's table."""
    bound = q_task_count(p, q, qe) * _NCOLS * 4
    if bound > budget:
        return False, bound
    nbytes = int(q_megakernel_task_table(p, q, qe)[0].nbytes)
    return nbytes <= budget, nbytes


def explain_dispatch_mode(p: int, q: int, nb: int, itemsize: int = 4, *,
                          vmem_budget: Optional[int] = None,
                          table_budget: Optional[int] = None
                          ) -> Tuple[str, str]:
    """The reference's ``dispatch_mode=None`` auto rule with its reason:
    ``"megakernel"`` when the task table fits ``table_budget`` and the
    double-buffered working set fits ``vmem_budget`` (the per-block
    on-chip budget: shared memory here), else ``"wavefront"``.  Budgets
    default to :data:`DEFAULT_SMEM_BUDGET` / :data:`DEFAULT_TABLE_BUDGET`.
    :func:`factor_tiles` and :func:`factor_tiles_batched` run the mode it
    picks when they are given ``dispatch_mode=None``."""
    need = macro_ops.megakernel_smem_bytes(nb, itemsize)
    vbudget = DEFAULT_SMEM_BUDGET if vmem_budget is None else int(vmem_budget)
    if need > vbudget:
        return "wavefront", (
            f"megakernel working set {need} B > shared-memory budget "
            f"{vbudget} B at nb={nb}, itemsize={itemsize}")
    tbudget = DEFAULT_TABLE_BUDGET if table_budget is None else int(table_budget)
    fits, tbytes = table_fits(p, q, tbudget)
    if not fits:
        return "wavefront", (
            f"({p}, {q}) grid's task table >= {tbytes} B > "
            f"table budget {tbudget} B")
    return "megakernel", (
        f"task table {tbytes} B <= budget {tbudget} B and working set "
        f"{need} B <= shared-memory budget {vbudget} B")


def resolve_dispatch_mode(p: int, q: int, nb: int, itemsize: int = 4, *,
                          vmem_budget: Optional[int] = None,
                          table_budget: Optional[int] = None) -> str:
    """The mode of :func:`explain_dispatch_mode`, without its reason."""
    return explain_dispatch_mode(p, q, nb, itemsize, vmem_budget=vmem_budget,
                                 table_budget=table_budget)[0]


@functools.lru_cache(maxsize=None)
def modeled_dma_bytes(p: int, q: int, nb: int,
                      itemsize: int = 4) -> Dict[str, int]:
    """Modeled workspace tile traffic of one factorization: ``wavefront``
    (every task fetches its tiles), ``megakernel`` (minus the reads its
    double buffer serves from the resident copy) and ``roofline`` (one
    read + one write of the workspace)."""
    tile = nb * nb * itemsize
    eng = 0
    for by_kind in wavefront_task_arrays(p, q):
        for kind, idx in by_kind.items():
            op = macro_ops.MACRO_OPS[kind]
            eng += idx.shape[0] * (op.tile_reads + op.tile_writes) * tile
    table = megakernel_task_table(p, q)[0]
    reused = int(table[:, _COL_REUSE0:_COL_REUSE0 + 3].sum())
    return dict(wavefront=eng, megakernel=eng - reused * tile,
                roofline=2 * p * q * tile)


def schedule_stats(p: int, q: int, nb: int = 32, itemsize: int = 4, *,
                   vmem_budget: Optional[int] = None,
                   table_budget: Optional[int] = None) -> Dict[str, object]:
    """Dispatch counts, table and working-set bytes and modeled traffic of
    both lowerings, with the reference's keys ("vmem" names the per-block
    on-chip working set, shared memory here)."""
    batches = wavefront_task_arrays(p, q)
    table, nlevels, nslots = megakernel_task_table(p, q)
    ntasks = int((table[:, _COL_KIND] != _NOOP).sum())
    dma = modeled_dma_bytes(p, q, nb, itemsize)
    vbudget = DEFAULT_SMEM_BUDGET if vmem_budget is None else int(vmem_budget)
    tbudget = DEFAULT_TABLE_BUDGET if table_budget is None else int(table_budget)
    return dict(
        p=p, q=q, nb=nb, levels=nlevels, tasks=ntasks,
        vmem_budget=vbudget, table_budget=tbudget,
        roofline_dma_bytes=dma["roofline"],
        wavefront=dict(
            dispatches=sum(len(b) for b in batches),
            vmem_bytes=macro_ops.engine_vmem_bytes(nb, itemsize),
            modeled_dma_bytes=dma["wavefront"],
        ),
        megakernel=dict(
            dispatches=1,
            grid=(nlevels, nslots),
            table_shape=tuple(table.shape),
            table_bytes=int(table.nbytes),
            padded_slots=nlevels * nslots - ntasks,
            reused_tile_fetches=int(
                table[:, _COL_REUSE0:_COL_REUSE0 + 3].sum()),
            reused_t_fetches=int(table[:, _COL_REUSET].sum()),
            vmem_bytes=macro_ops.megakernel_smem_bytes(nb, itemsize),
            modeled_dma_bytes=dma["megakernel"],
        ),
        auto=resolve_dispatch_mode(p, q, nb, itemsize, vmem_budget=vbudget,
                                   table_budget=tbudget),
    )


def dispatch_counts(p: int, q: int, dispatch_mode: str = "wavefront",
                    batch: int = 1) -> Dict[str, int]:
    """Kernel launches of one factor call on ``batch`` stacked ``(p, q)``
    grids, keyed as ``macro_ops.LAUNCHES``: per kind for the wavefront
    lowering (one factorization's, whatever ``batch``: each launch runs
    its batch on every slice), one megakernel launch for the megakernel
    lowering (the batched one when ``batch > 1``)."""
    if dispatch_mode == "megakernel":
        return {"MEGAKERNEL_BATCHED" if batch > 1 else "MEGAKERNEL": 1}
    counts = dict.fromkeys(_KIND_ORDER, 0)
    for by_kind in wavefront_task_arrays(p, q):
        for kind in by_kind:
            counts[kind] += 1
    return counts


def resolve_q_dispatch_mode(p: int, q: int, qe: int, mode: str,
                            forced: bool = False) -> str:
    """The lowering Q formation runs after a factorization that ran
    ``mode``: the same, except that a megakernel picked by the auto rule
    whose Q table exceeds :data:`DEFAULT_TABLE_BUDGET` forms Q by the
    wavefront launches (a forced one raises, see :func:`check_table`)."""
    if mode != "megakernel":
        return "wavefront"
    if forced:
        check_table(p, q, qe=qe)
        return mode
    return mode if q_table_fits(p, q, qe, DEFAULT_TABLE_BUDGET)[0] \
        else "wavefront"


def q_dispatch_counts(p: int, q: int, qe: int,
                      dispatch_mode: str = "wavefront",
                      batch: int = 1) -> Dict[str, int]:
    """Kernel launches of one Q formation on ``batch`` stacked grids,
    keyed as ``macro_ops.LAUNCHES``: per Q kind for the wavefront lowering
    (at most two a level, whatever ``batch``), one megakernel launch over
    the Q table for the megakernel lowering."""
    if dispatch_mode == "megakernel":
        return {"MEGAKERNEL_Q_BATCHED" if batch > 1 else "MEGAKERNEL_Q": 1}
    counts = dict.fromkeys(Q_KINDS, 0)
    for by_kind in q_task_arrays(p, q, qe):
        for kind in by_kind:
            counts[kind] += 1
    return {k: v for k, v in counts.items() if v}


# ---------------------------------------------------------------------------
# device index arrays
# ---------------------------------------------------------------------------

_DEVICE_INDEX: Dict[Tuple, Tuple[Dict[str, torch.Tensor], ...]] = {}


def _upload_levels(key: Tuple, levels, kinds: Tuple[str, ...],
                   device: torch.device
                   ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """``levels`` (per level, kind -> ``(n, 3)`` int32 array) on
    ``device``: one upload per ``key``, then per-level views into it, in
    ``kinds``' order within a level."""
    if key not in _DEVICE_INDEX:
        flat = [by_kind[kind] for by_kind in levels
                for kind in kinds if kind in by_kind]
        dev = torch.from_numpy(np.concatenate(flat)).to(device)
        out, row = [], 0
        for by_kind in levels:
            views = {}
            for kind in kinds:
                if kind in by_kind:
                    n = by_kind[kind].shape[0]
                    views[kind] = dev[row:row + n]
                    row += n
            out.append(views)
        _DEVICE_INDEX[key] = tuple(out)
    return _DEVICE_INDEX[key]


def level_indices(p: int, q: int, device: torch.device
                   ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The schedule's per-level ``(n, 3)`` int32 index arrays on
    ``device``: one upload per ``(p, q, device)``, then views into it.
    Asserts the property the kernels' parallel CTAs rely on: the tasks
    of one level never write the same tile."""
    key = (p, q, str(device))
    if key not in _DEVICE_INDEX:
        levels = wavefront_task_arrays(p, q)
        for by_kind in levels:
            writes = [w for kind, idx in by_kind.items()
                      for k, i, j in idx.tolist()
                      for w in _task_writes(kind, k, i, j)]
            assert len(writes) == len(set(writes)), "same-level write overlap"
        _upload_levels(key, levels, _KIND_ORDER, device)
    return _DEVICE_INDEX[key]


_DEVICE_TABLE: Dict[Tuple, Tuple[torch.Tensor, int, int]] = {}


def megakernel_table(p: int, q: int, device: torch.device
                     ) -> Tuple[torch.Tensor, int, int]:
    """``(table, nlevels, nslots)`` of :func:`megakernel_task_table` with
    the table on ``device``: one upload per ``(p, q, device)``.  Asserts
    what the megakernel's concurrent CTAs rely on: each level's tasks
    precede its NOOP rows, and no task reads a tile that another task of
    its level writes — save LARFB's read of the V1 below the diagonal of
    tile (k, k), whose upper triangle a TSQRT of that level rewrites."""
    key = (p, q, str(device))
    if key not in _DEVICE_TABLE:
        table, nlevels, nslots = megakernel_task_table(p, q)
        for lv in range(nlevels):
            rows = table[lv * nslots:(lv + 1) * nslots]
            n = int((rows[:, _COL_KIND] != _NOOP).sum())
            assert (rows[n:, _COL_KIND] == _NOOP).all(), "NOOP before a task"
            tasks = [(_KIND_ORDER[kind], k, i, j)
                     for kind, k, i, j in rows[:n, :4].tolist()]
            writer = {w: t for t in tasks for w in _task_writes(*t)}
            for t in tasks:
                for tile in _task_reads(*t):
                    other = writer.get(tile, t)
                    assert other == t or (t[0], other[0]) == ("LARFB", "TSQRT"), \
                        ("same-level read of a written tile", t, other)
        _DEVICE_TABLE[key] = (torch.from_numpy(table).to(device), nlevels,
                              nslots)
    return _DEVICE_TABLE[key]


def q_level_indices(p: int, q: int, qe: int, device: torch.device
                    ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Q formation's per-level ``(n, 3)`` int32 index arrays on
    ``device``: one upload per ``(p, q, qe, device)``, then views into it
    (:func:`q_task_arrays` asserts the levels' writes disjoint)."""
    return _upload_levels(("q", p, q, qe, str(device)),
                          q_task_arrays(p, q, qe), Q_KINDS, device)


def q_megakernel_table(p: int, q: int, qe: int, device: torch.device
                       ) -> Tuple[torch.Tensor, int, int]:
    """``(table, nlevels, nslots)`` of :func:`q_megakernel_task_table`
    with the table on ``device``: one upload per ``(p, q, qe, device)``."""
    key = ("q", p, q, qe, str(device))
    if key not in _DEVICE_TABLE:
        table, nlevels, nslots = q_megakernel_task_table(p, q, qe)
        _DEVICE_TABLE[key] = (torch.from_numpy(table).to(device), nlevels,
                              nslots)
    return _DEVICE_TABLE[key]


def prepare_dispatch(p: int, q: int, nb: int, dtype: torch.dtype,
                     device, mode: str, batch: int = 1,
                     qe: Optional[int] = None) -> None:
    """Upload ahead of a first call what the kernel lowering ``mode``
    reads on ``device`` for ``batch`` stacked ``(p, q)`` grids — the level
    indices, or the task table and, on a card, the CTA runs of the launch's
    grid — and, with ``qe``, the same for Q formation of ``qe`` column
    tiles, so the calls themselves upload nothing.  Raises where the call
    would: a megakernel Q table over budget (the lowering is forced), or no
    CTA of the launch fitting the card."""
    device = torch.device(device)
    suffix = "_BATCHED" if batch > 1 else ""
    if mode != "megakernel":
        level_indices(p, q, device)
        if qe is not None:
            q_level_indices(p, q, qe, device)
        return
    runs = [("MEGAKERNEL" + suffix, megakernel_table(p, q, device)[2], None)]
    if qe is not None:
        resolve_q_dispatch_mode(p, q, qe, mode, forced=True)
        runs.append(("MEGAKERNEL_Q" + suffix,
                     q_megakernel_table(p, q, qe, device)[2], qe))
    if device.type == "cuda":
        for name, nslots, qe_ in runs:
            grid = macro_ops.megakernel_grid(name, nb, dtype, device, batch,
                                             nslots)
            megakernel_runs_device(p, q, batch, grid, device, qe=qe_)


# ---------------------------------------------------------------------------
# the factor loop
# ---------------------------------------------------------------------------

def init_state(tiles: torch.Tensor) -> FactorState:
    """Fresh state around a ``(..., p, q, nb, nb)`` workspace (not
    copied); leading dimensions stack independent factorizations."""
    *lead, p, q, nb, _ = tiles.shape
    r = min(p, q)
    z = functools.partial(torch.zeros, dtype=tiles.dtype, device=tiles.device)
    return FactorState(tiles, z((*lead, r, nb, nb)), z((*lead, r, nb)),
                       z((*lead, p, r, nb, nb)), z((*lead, p, r, nb)))


def run_levels(state: FactorState, levels: Optional[Iterable[int]] = None, *,
               use_kernel: bool = False) -> FactorState:
    """Run the given wavefront levels (default: all) of the schedule on
    ``state``, in place.  One launch per (level, kind) in the canonical
    order: within a level the only tile two kinds share is the diagonal,
    whose strictly-lower V1 LARFB reads before TSQRT rewrites the upper
    triangle.  A stacked state (one leading dimension on the kernels, any
    on the plain versions) runs each batch over all its slices."""
    tiles = state.tiles
    p, q = tiles.shape[-4:-2]
    per_level = level_indices(p, q, tiles.device)
    for lv in range(len(per_level)) if levels is None else levels:
        for kind, idx in per_level[lv].items():
            with _profiler.annotate(_profiler.kernel_label(kind, lv)):
                macro_ops.run_batch(kind, state, idx, use_kernel=use_kernel)
    return state


def _check_dispatch(dtype: torch.dtype, p: int, q: int, nb: int,
                    use_kernel: bool, dispatch_mode: Optional[str],
                    batched: bool = False, *, fault_site: bool = True) -> str:
    """Guards of the factor entry points; returns the lowering the kernel
    path runs.  Raises for an unknown dispatch mode, a dtype the kernels
    do not take, and (:class:`BudgetError`) a launch whose shared memory
    exceeds the budget or a forced megakernel whose table exceeds
    :data:`DEFAULT_TABLE_BUDGET` (the auto rule never picks one).
    ``batched`` names the stacked entry point in the messages: its CTAs
    take the single launch's shared memory, and its table is the single
    schedule's.  With ``fault_site``, an armed ``vmem`` fault
    (:mod:`repro_torch.robustness.inject`) raises here, where a real
    over-budget workspace does, with the reference's tag; Q formation,
    which resolves its factorization's lowering again, passes False."""
    if dispatch_mode not in (None,) + DISPATCH_MODES:
        raise ValueError(
            f"unknown dispatch_mode {dispatch_mode!r}; expected one of "
            f"{DISPATCH_MODES} or None (auto)")
    if fault_site and _inject.enabled():
        _inject.check("vmem", f"p{p}q{q}nb{nb}:{dispatch_mode}")
    if not use_kernel:
        return "wavefront"
    if dtype not in macro_ops.KERNEL_DTYPES:
        raise TypeError(f"the macro-op kernels take float32 or float64, "
                        f"got {dtype}")
    mode = (resolve_dispatch_mode(p, q, nb, dtype.itemsize)
            if dispatch_mode is None else dispatch_mode)
    if mode == "megakernel":
        check_table(p, q, batched)
    check_smem(nb, dtype.itemsize, mode, batched)
    return mode


class BudgetError(ValueError):
    """A lowering's working set or task table is past its budget: a
    planning verdict about the shape, not a failure of a kernel (the
    service's plan build walks ``megakernel -> wavefront`` on it)."""


def check_smem(nb: int, itemsize: int, mode: str = "wavefront",
               batched: bool = False) -> None:
    """Raise when the ``mode`` lowering's per-CTA shared memory at tile
    ``nb`` exceeds :data:`DEFAULT_SMEM_BUDGET`."""
    need = (macro_ops.megakernel_launch_smem_bytes(nb, itemsize)
            if mode == "megakernel" else
            macro_ops.engine_smem_bytes(nb, itemsize))
    if need > DEFAULT_SMEM_BUDGET:
        raise BudgetError(
            f"tile ({nb},{nb}) exceeds the {'batched ' * batched}{mode} "
            f"shared-memory budget ({need} > {DEFAULT_SMEM_BUDGET} B at "
            f"itemsize {itemsize}); shrink the tile")


def check_table(p: int, q: int, batched: bool = False,
                qe: Optional[int] = None) -> None:
    """Raise when the ``(p, q)`` grid's megakernel task table exceeds
    :data:`DEFAULT_TABLE_BUDGET`, as the reference does for a forced
    megakernel; with ``qe``, Q formation's table of ``qe`` column tiles."""
    fits, tbytes = (table_fits(p, q, DEFAULT_TABLE_BUDGET) if qe is None
                    else q_table_fits(p, q, qe, DEFAULT_TABLE_BUDGET))
    if not fits:
        raise BudgetError(
            f"({p}, {q}) grid's {'batched ' * batched}megakernel "
            f"{'' if qe is None else f'Q ({qe} column tiles) '}task table "
            f"(>= {tbytes} bytes) exceeds the table budget "
            f"({DEFAULT_TABLE_BUDGET}); grow the tile or use "
            f"dispatch_mode='wavefront'")


def _check_workspace(tiles: torch.Tensor, shape: Tuple[int, ...]) -> None:
    if tuple(tiles.shape) != shape:
        raise ValueError(f"expected a {shape} tile workspace, "
                         f"got {tuple(tiles.shape)}")
    if not tiles.is_contiguous():
        raise ValueError("the tile workspace must be contiguous")


def _emit_factor_metrics(tiles: torch.Tensor, p: int, q: int, nb: int,
                         mode: str, use_kernel: bool, batch: int = 1) -> None:
    """Record one factor call in the ``engine.*`` metric series: calls,
    matrices, launches, tasks and the roofline tile traffic of the
    lowering that runs, and the task table's bytes on the megakernel
    path (not the reference's ``engine.modeled_dma_bytes``: a TPU tile
    model, not the card's traffic).  A stack takes one schedule's
    launches on either kernel lowering.  The reference labels calls
    counted while tracing a program ``phase="trace"``; the port runs no
    traced program, so every call counts as ``phase="execute"``."""
    phase = "execute"
    kernel = "cuda" if use_kernel else "plain"
    if not use_kernel:
        ndisp = 0
    elif mode == "megakernel":
        ndisp = 1
    else:
        ndisp = sum(len(b) for b in wavefront_task_arrays(p, q))
    roofline = modeled_dma_bytes(p, q, nb, tiles.element_size())["roofline"]
    _metrics.counter("engine.factor_calls", mode=mode, kernel=kernel,
                     phase=phase).inc()
    _metrics.counter("engine.matrices", mode=mode, phase=phase).inc(batch)
    _metrics.counter("engine.dispatches", mode=mode, phase=phase).inc(ndisp)
    _metrics.counter("engine.tasks", mode=mode, phase=phase).inc(
        task_count(p, q) * batch)
    _metrics.counter("engine.roofline_dma_bytes", mode=mode,
                     phase=phase).inc(roofline * batch)
    if use_kernel and mode == "megakernel":
        _metrics.gauge("engine.table_bytes", grid=f"{p}x{q}").set(
            megakernel_task_table(p, q)[0].nbytes)


def _factor_single(tiles: torch.Tensor, p: int, q: int, nb: int,
                   use_kernel: bool, mode: str) -> FactorState:
    state = init_state(tiles)
    if use_kernel and mode == "megakernel":
        with _profiler.annotate(_profiler.megakernel_label(p, q)):
            macro_ops.megakernel(state, *megakernel_table(p, q, tiles.device))
        return state
    return run_levels(state, use_kernel=use_kernel)


def factor_tiles(tiles: torch.Tensor, *, p: int, q: int, nb: int,
                 use_kernel: bool = False,
                 dispatch_mode: Optional[str] = None) -> FactorState:
    """Run the whole schedule over a ``(p, q, nb, nb)`` workspace, in place:
    the returned state's ``tiles`` is ``tiles`` itself, factored.

    ``use_kernel=True`` launches the CUDA kernels (a CUDA workspace;
    on a CPU workspace the wrappers run their plain versions) by the
    lowering ``dispatch_mode`` names: "wavefront" (one launch per level
    and kind), "megakernel" (one launch), or None for the auto rule.
    ``False`` runs the plain lowering.
    """
    _check_workspace(tiles, (p, q, nb, nb))
    mode = _check_dispatch(tiles.dtype, p, q, nb, use_kernel, dispatch_mode)
    _emit_factor_metrics(tiles, p, q, nb, mode, bool(use_kernel))
    with _trace.span("engine.factor_tiles", mode=mode, grid=f"{p}x{q}",
                     nb=nb, kernel=bool(use_kernel)):
        return _factor_single(tiles, p, q, nb, use_kernel, mode)


def factor_tiles_batched(tiles: torch.Tensor, *, p: int, q: int, nb: int,
                         use_kernel: bool = False,
                         dispatch_mode: Optional[str] = None,
                         filled: Optional[int] = None) -> FactorState:
    """Run the schedule over every slice of a stacked ``(B, p, q, nb, nb)``
    workspace, in place; each slice's state equals :func:`factor_tiles`
    on that slice.  The megakernel lowering is one launch of the batched
    megakernel for the whole stack; the wavefront lowering, on the kernels
    or their plain versions, runs each level's batches over the stack at
    once: one launch per (level, kind) for all the slices.  ``B == 1``
    runs the single path, as the reference does.

    ``filled`` says the slices from it on are zero matrices (a padded
    batch): a zero matrix factors to the zero state, so the wavefront
    lowerings run only the first ``filled`` slices and leave the rest as
    :func:`init_state` made them; the megakernel runs the whole stack in
    its one launch either way.  Each stacked call of the wavefront kernel
    lowering adds ``filled`` to ``engine.stacked_wavefront_slices
    {stage="factor"}``."""
    if tiles.ndim != 5 or tiles.shape[0] < 1:
        raise ValueError(f"expected a (B >= 1, {p}, {q}, {nb}, {nb}) "
                         f"stacked workspace, got {tuple(tiles.shape)}")
    _check_workspace(tiles, (tiles.shape[0], p, q, nb, nb))
    mode = _check_dispatch(tiles.dtype, p, q, nb, use_kernel, dispatch_mode,
                           batched=True)
    batch = int(tiles.shape[0])
    filled = batch if filled is None else max(1, min(int(filled), batch))
    _emit_factor_metrics(tiles, p, q, nb, mode, bool(use_kernel), batch)
    with _trace.span("engine.factor_tiles_batched", mode=mode,
                     grid=f"{p}x{q}", nb=nb, batch=batch,
                     kernel=bool(use_kernel)):
        return _factor_batched(tiles, p, q, nb, use_kernel, mode, filled)


def _factor_batched(tiles: torch.Tensor, p: int, q: int, nb: int,
                    use_kernel: bool, mode: str, filled: int) -> FactorState:
    batch = tiles.shape[0]
    if batch == 1:
        single = _factor_single(tiles[0], p, q, nb, use_kernel, mode)
        return FactorState(tiles, *(x[None] for x in single[1:]))
    state = init_state(tiles)
    if use_kernel and mode == "megakernel":
        with _profiler.annotate(_profiler.megakernel_label(p, q, batch)):
            macro_ops.megakernel_batched(
                state, *megakernel_table(p, q, tiles.device))
        return state
    # Each level's batches over the filled slices at once (a leading slice
    # of the stack, still contiguous).
    if use_kernel:
        _metrics.counter("engine.stacked_wavefront_slices",
                         stage="factor").inc(filled)
    run_levels(FactorState(*(x[:filled] for x in state)),
               use_kernel=use_kernel)
    return state


# ---------------------------------------------------------------------------
# Q formation on the kernels
# ---------------------------------------------------------------------------

def q_workspace(lead: Tuple[int, ...], p: int, qe: int, nb: int,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A ``(*lead, p, qe, nb, nb)`` Q workspace holding the identity: tile
    (d, d) = I for d < min(p, qe), every other tile zero."""
    e = torch.zeros(tuple(lead) + (p, qe, nb, nb), dtype=dtype, device=device)
    d = torch.arange(min(p, qe), device=device)
    e[..., d, d, :, :] = torch.eye(nb, dtype=dtype, device=device)
    return e


def run_q_levels(state: FactorState, e: torch.Tensor,
                 levels: Optional[Iterable[int]] = None, *,
                 use_kernel: bool = True) -> torch.Tensor:
    """Run the given levels (default: all) of Q formation's schedule on
    the ``(p, qe, nb, nb)`` Q workspace ``e`` — or every slice of a
    ``(B, p, qe, nb, nb)`` stack of them beside a stacked ``state`` — in
    place, the factored ``state`` read only: one launch per (level, kind)
    through the Q kernels' wrappers (their plain versions on CPU tensors),
    or, with ``use_kernel=False``, the plain versions everywhere."""
    p, q = state.tiles.shape[-4:-2]
    per_level = q_level_indices(p, q, e.shape[-3], e.device)
    for lv in range(len(per_level)) if levels is None else levels:
        for kind, idx in per_level[lv].items():
            with _profiler.annotate(_profiler.kernel_label(kind, lv)):
                macro_ops.run_q_batch(kind, state, e, idx,
                                      use_kernel=use_kernel)
    return e


def form_q_tiles(state: FactorState, ncols: int, *,
                 dispatch_mode: Optional[str] = None,
                 filled: Optional[int] = None) -> torch.Tensor:
    """Q's first ``ncols`` columns (a multiple of nb) from a factored
    state — ``(p, q, nb, nb)`` or a ``(B, p, q, nb, nb)`` stack — as a
    ``(*lead, p, ncols / nb, nb, nb)`` tile workspace, through the Q
    kernels, by the lowering the factorization ran (``dispatch_mode`` as
    given to it; :func:`resolve_q_dispatch_mode`): one megakernel launch
    over the Q table (one batched launch for a stack of more than one),
    or one launch per (level, kind) for the first ``filled`` slices of
    the stack at once (the rest are zero states, whose Q is the
    workspace's identity, as :func:`factor_tiles_batched` says; each such
    stacked call adds ``filled`` to ``engine.stacked_wavefront_slices
    {stage="q"}``).  On a CPU state the wrappers run their plain versions;
    the plain lowering of ``tilegraph._form_q_tiled`` is the reference
    they are held against."""
    tiles = state.tiles
    *lead, p, q, nb, _ = tiles.shape
    if ncols % nb or len(lead) > 1:
        raise ValueError(f"form_q_tiles: ncols must be a multiple of the "
                         f"tile {nb} and the state (p, q, ...) or (B, p, q, "
                         f"...), got ncols={ncols}, {tuple(tiles.shape)}")
    qe = ncols // nb
    batch = lead[0] if lead else 1
    mode = _check_dispatch(tiles.dtype, p, q, nb, True, dispatch_mode,
                           batched=batch > 1, fault_site=False)
    mode = resolve_q_dispatch_mode(p, q, qe, mode,
                                   forced=dispatch_mode == "megakernel")
    e = q_workspace(tuple(lead), p, qe, nb, tiles.dtype, tiles.device)
    if mode == "megakernel":
        table = q_megakernel_table(p, q, qe, tiles.device)
        with _profiler.annotate(
                "q:" + _profiler.megakernel_label(p, q, batch)):
            if batch > 1:
                macro_ops.megakernel_q_batched(state, e, *table)
            elif lead:
                macro_ops.megakernel_q(FactorState(*(x[0] for x in state)),
                                       e[0], *table)
            else:
                macro_ops.megakernel_q(state, e, *table)
        return e
    if not lead:
        return run_q_levels(state, e)
    filled = batch if filled is None else max(1, min(int(filled), batch))
    if batch > 1:
        _metrics.counter("engine.stacked_wavefront_slices",
                         stage="q").inc(filled)
    run_q_levels(FactorState(*(x[:filled] for x in state)), e[:filled])
    return e
