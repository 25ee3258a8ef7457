"""Render (or capture) an observability report.

Counterpart of the reference's ``repro.observability.report``.  Render a
previously exported capture:

    python -m repro_torch.observability.report --trace trace.json
    python -m repro_torch.observability.report --metrics metrics.json

Run an instrumented smoke workload (planner explains incl. a fallback,
a serving mix through the port's ``QRService``) on ``--device`` (default
``cuda``; ``cpu`` runs the plain lowering) and write + render the
artifacts:

    python -m repro_torch.observability.report --capture out_dir/ --device cpu

With no arguments, renders whatever the current process has recorded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional


def _render_trace(doc: Dict[str, Any]) -> str:
    events = sorted(doc.get("traceEvents", []), key=lambda e: e.get("ts", 0))
    if not events:
        return "(empty trace)"
    t0 = events[0]["ts"]
    # Rebuild nesting from containment: an event is a child of the most
    # recent event (per tid) whose [ts, ts+dur] interval encloses it.
    lines = ["trace tree (ts offsets in us):"]
    open_stack: Dict[Any, list] = {}
    for ev in events:
        tid = ev.get("tid", 0)
        stack = open_stack.setdefault(tid, [])
        end = ev["ts"] + ev.get("dur", 0.0)
        while stack and stack[-1] < ev["ts"] + 1e-9:
            stack.pop()
        depth = len(stack)
        stack.append(end)
        args = ev.get("args") or {}
        label = " ".join(f"{k}={v}" for k, v in args.items())
        lines.append(f"  {ev['ts'] - t0:12.1f}  {'  ' * depth}"
                     f"{ev.get('name', '?'):<40s} {ev.get('dur', 0):10.1f} us"
                     + (f"  [{label}]" if label else ""))
    return "\n".join(lines)


def _render_metrics(snap: Dict[str, Any]) -> str:
    lines = ["metrics snapshot:"]
    for name, series in sorted((snap.get("counters") or {}).items()):
        for s in series:
            label = ",".join(f"{k}={v}" for k, v in
                             sorted((s.get("labels") or {}).items()))
            lines.append(f"  counter   {name}{'{' + label + '}' if label else ''}"
                         f" = {s['value']:g}")
    for name, series in sorted((snap.get("gauges") or {}).items()):
        for s in series:
            label = ",".join(f"{k}={v}" for k, v in
                             sorted((s.get("labels") or {}).items()))
            lines.append(f"  gauge     {name}{'{' + label + '}' if label else ''}"
                         f" = {s['value']:g}")
    for name, series in sorted((snap.get("histograms") or {}).items()):
        for s in series:
            label = ",".join(f"{k}={v}" for k, v in
                             sorted((s.get("labels") or {}).items()))
            lines.append(
                f"  histogram {name}{'{' + label + '}' if label else ''}"
                f" count={s['count']} mean={s['mean']:.1f}"
                f" p50={s['p50']:.1f} p99={s['p99']:.1f}"
                f" max={s['max']:.1f}")
    if len(lines) == 1:
        lines.append("  (empty)")
    return "\n".join(lines)


def _capture_smoke(out_dir: str, device: str = "cuda") -> Dict[str, str]:
    """Run an instrumented smoke workload on ``device``; write trace +
    metrics files."""
    import numpy as np

    from repro_torch import observability as obs
    from repro_torch.core import QRConfig, plan
    from repro_torch.core.plan import resolve_device
    from repro_torch.serving import BucketingPolicy, QRService

    backend = resolve_device(device).type
    os.makedirs(out_dir, exist_ok=True)
    obs.enable()
    obs.trace.clear()

    with obs.span("smoke.capture", device=device):
        # Planner explains: a routed shape, plus one that trips the CPU
        # floor fallback on the CPU (on a card it routes tiled).
        with obs.span("smoke.plan"):
            for shape, cfg in [((512, 512), QRConfig()),
                               ((300, 280), QRConfig())]:
                sol = plan(shape, config=cfg, backend=backend, explain=True)
                rec = sol.explain
                print(f"plan{shape}: method={sol.config.method} "
                      f"dispatch={rec.dispatch_mode} "
                      f"fallbacks={list(rec.fallback_reasons)}")

        # Serving mix: bucket -> plan -> dispatch -> unpad spans.
        with obs.span("smoke.serve"):
            rng = np.random.default_rng(0)
            service = QRService(policy=BucketingPolicy(tile=16, max_batch=8),
                                device=device)
            mix = [rng.standard_normal(s).astype(np.float32)
                   for s in [(48, 48), (45, 41), (96, 32), (48, 48),
                             (37, 23), (64, 64)]]
            results = service.submit_many(mix)
            with obs.span("smoke.check") as sp:
                for res in results:
                    sp.sync((res.q, res.r))
            service.submit_many(mix)  # warm-cache pass

    trace_path = os.path.join(out_dir, "trace.json")
    metrics_path = os.path.join(out_dir, "metrics.json")
    prom_path = os.path.join(out_dir, "metrics.prom")
    obs.export_chrome_trace(trace_path)
    with open(metrics_path, "w") as f:
        json.dump(obs.snapshot(), f, indent=1)
    with open(prom_path, "w") as f:
        f.write(obs.metrics.to_prometheus())
    return {"trace": trace_path, "metrics": metrics_path, "prom": prom_path}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.observability.report",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace", help="Chrome trace JSON file to render")
    ap.add_argument("--metrics", help="metrics snapshot JSON file to render")
    ap.add_argument("--capture", metavar="OUT_DIR",
                    help="run an instrumented smoke workload and write "
                         "trace.json + metrics.json + metrics.prom there")
    ap.add_argument("--device", default="cuda",
                    help="device the --capture workload runs on "
                         "(default cuda; cpu runs the plain lowering)")
    args = ap.parse_args(argv)

    if args.capture:
        paths = _capture_smoke(args.capture, args.device)
        with open(paths["trace"]) as f:
            print(_render_trace(json.load(f)))
        with open(paths["metrics"]) as f:
            print(_render_metrics(json.load(f)))
        print(f"wrote {', '.join(sorted(paths.values()))}")
        return 0

    rendered = False
    if args.trace:
        with open(args.trace) as f:
            print(_render_trace(json.load(f)))
        rendered = True
    if args.metrics:
        with open(args.metrics) as f:
            print(_render_metrics(json.load(f)))
        rendered = True
    if not rendered:
        from repro_torch import observability as obs

        print(obs.tree())
        print(_render_metrics(obs.snapshot()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
