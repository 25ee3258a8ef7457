"""The traced window: a ``torch.profiler`` capture read in memory, and the
program's host spans placed on the profiler's clock.

:class:`Capture` records the device's operations (kernels, copies,
fills) with the host time of the call that launched each; nothing is
written to disk.  :class:`Trace` is what the per-layer readers see.
"""

from __future__ import annotations

import time
from collections import defaultdict

from torch.autograd import DeviceType

# Host calls that put work on the device (the CUDA runtime's cuda* and cu* calls).
_LAUNCH_PREFIXES = ("cuda", "cu")


def _annotation(e) -> bool:
    """A profiler range shown on the device's timeline, not an op."""
    is_ann = getattr(e, "is_user_annotation", None)
    return bool(is_ann()) if is_ann is not None else False


class Capture:
    """``with Capture(on) as cap: ...`` profiles the block when ``on``;
    ``cap.trace`` is then a :class:`Trace` (its events read on first use,
    after the window), else None."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None
        self._results = None
        self._trace = None

    @property
    def trace(self):
        if self._trace is None and self._results is not None:
            self._trace = Trace(self._results.events(), self._t0, self._t1, self._offset)
            self._results = None
        return self._trace

    def __enter__(self):
        if self.on:
            import torch

            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._t0 = time.time_ns()
            self._offset = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch

        torch.cuda.synchronize()
        self._t1 = time.time_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._results = self._prof.profiler.kineto_results
        self._prof = None
        return False


class Trace:
    """The device operations of a traced window: ``ops`` as (name, start
    ns, end ns, launch ns or None), the window (``t0``, ``t1``, ns) and
    ``offset``, which takes ``time.perf_counter()`` ns to the trace's
    clock."""

    def __init__(self, events, t0: int, t1: int, offset: int):
        launches, ops = {}, []
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if not _annotation(e):
                    ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                                e.correlation_id(), e.linked_correlation_id()))
            elif name.startswith(_LAUNCH_PREFIXES):
                launches[e.correlation_id()] = e.start_ns()
        self.ops = [(n, s, t, launches.get(c, launches.get(lc)))
                    for n, s, t, c, lc in ops]
        self.t0, self.t1, self.offset = t0, t1, offset

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self, ops=None) -> list:
        """The union of the ops' intervals inside the window, merged."""
        ivs = sorted((max(s, self.t0), min(t, self.t1))
                     for _, s, t, _ in (self.ops if ops is None else ops))
        merged = []
        for s, t in ivs:
            if t <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def busy_s(self, ops=None) -> float:
        return sum(t - s for s, t in self.busy(ops)) / 1e9

    def launched_within(self, spans) -> list:
        """The ops launched inside any of ``spans`` ((start, end) in
        ``time.perf_counter()`` seconds)."""
        ivs = sorted((int(a * 1e9) + self.offset, int(b * 1e9) + self.offset)
                     for a, b in spans)
        out = []
        for op in self.ops:
            lt = op[3]
            if lt is not None and any(a <= lt <= b for a, b in ivs):
                out.append(op)
        return out

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(int)
        for name, s, t, _ in self.ops:
            total[name] += t - s
        return [[k[:120], v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans, n: int = 10) -> list:
        """The longest gaps with no device op, each named by the innermost
        of ``spans`` ((name, start, end), perf_counter seconds) that
        holds its middle."""
        busy = self.busy()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        named = [(name, int(a * 1e9) + self.offset, int(b * 1e9) + self.offset)
                 for name, a, b in spans]
        out = []
        for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + t) // 2
            holding = [(b - a, name) for name, a, b in named if a <= mid <= b]
            out.append([min(holding)[1] if holding else "outside the program's spans",
                        (t - s) / 1e9])
        return out
