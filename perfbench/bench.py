"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its traffic kind, reads its metrics and prints the result line.

Layout (each found by name; a new cell, configuration, traffic mix or
metric is new files and new entries, never an edit):

    perfbench/configs/<config>.json     sizes as run, the cut, the source
    perfbench/workloads/<cell>.json     configuration, traffic, limits
    perfbench/traffic/<traffic>.json    the mix's parameters and its kind
    perfbench/traffic/<kind>.py         set-up, window and check of a kind
    perfbench/metrics/<metric>.py       ``read(ctx)`` of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Module top-level names that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """One cell's run: its files, the run's arguments, and the program's
    configuration."""

    def __init__(self, name: str, *, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: float | None = None,
                 root: Path = ROOT, smoke: bool = False):
        self.bench = load_json(root / "BENCHMARK.json")
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.name, self.entry = name, entry
        self.root = root
        self.spec = load_json(root / "perfbench" / "workloads" / f"{name}.json")
        self.config = load_json(root / "perfbench" / "configs" / f"{entry['config']}.json")
        self.traffic = load_json(root / "perfbench" / "traffic" / f"{entry['traffic']}.json")
        self.kind = load_module(root / "perfbench" / "traffic" / f"{self.traffic['kind']}.py")
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.smoke = smoke
        self.limits = self.spec["limits"]

    def model(self) -> dict:
        """The sizes as run (the configuration file's ``model``, or its
        ``smoke`` sizes in a test)."""
        m = dict(self.config["model"])
        if self.smoke:
            m.update(self.config["smoke"])
        return m

    def ref_config(self):
        from perfbench.reference.model import make_config

        return make_config(self.model())

    def port_config(self):
        """The program's configuration: its registry entry with the
        file's overrides, checked against the sizes the file states."""
        import dataclasses

        from repro_torch.configs import get_config
        from repro_torch.configs.base import MoEConfig

        m = self.model()
        base = get_config(self.config["arch"])
        over = {k: v for k, v in m.items() if k not in ("period", "moe", "name")}
        if m.get("moe"):
            over["moe"] = MoEConfig(**m["moe"])
        if not self.smoke:
            differ = [k for k, v in over.items() if k not in self.config["overrides"]
                      and getattr(base, k) != v]
            if differ:
                raise ValueError(f"{self.config['arch']}: the file's {differ} are "
                                 f"not the registry's and not among its overrides")
        cfg = dataclasses.replace(base, **over)
        period = [[s.mixer, s.ffn] for s in cfg.period]
        if period != m["period"]:
            raise ValueError(f"{self.config['arch']}: period {period} != {m['period']}")
        return cfg

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports."""
        reported = {e["name"] for e in self.bench["end_to_end"]
                    if self.name in e.get("workloads", [self.name])}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in reported]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A harness file loaded by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell: Cell, ctx: dict) -> dict:
    """``{name: {"value", "unit"}}`` of each per-layer metric whose
    reader found something to read."""
    out = {}
    for m in cell.per_layer():
        reader = load_module(cell.root / "perfbench" / "metrics" / f"{m['name']}.py")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = root / "build" / "perfbench_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TORCHINDUCTOR_CACHE_DIR": str(base / "inductor"),
            "CUDA_CACHE_PATH": str(base / "nv")}


def device_info(torch, device: str, peak: int) -> dict:
    """The result's ``device``: ``peak``, the peak bytes the run allocated
    on the card before its reference ran (a CPU test run names no card)."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(peak)}


def result_line(cell: Cell, out: dict) -> dict:
    """The last line: ``correct``, ``attempted``, ``failed``, the trace-
    dependent metrics, ``device`` and ``breakdown``, then the checks."""
    checks = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": out["metrics"],
            "device": out["device"]}
    if out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def run(cell: Cell) -> dict:
    """The cell's run through its traffic kind; with tracing, its
    per-layer metrics read."""
    out = cell.kind.run(cell)
    if cell.trace:
        out["metrics"] = read_metrics(cell, out["ctx"])
        tr = out["ctx"].get("trace")
        if tr is not None:
            linked = sum(op[3] is not None for op in tr.ops)
            print(f"perfbench: traced {len(tr.ops)} device ops, {linked} with their "
                  f"launch, window {tr.window_s:.3f} s", file=sys.stderr)
    return out


def env_ready() -> None:
    os.environ.update(cache_env())
    for d in cache_env().values():
        os.makedirs(d, exist_ok=True)
