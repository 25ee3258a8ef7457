"""The harness's contract, on the CPU: every cell resolves to its files
and every metric to its reader; names and units are plain; a cell added
as new files is found without an edit; nothing loads JAX or the JAX
package; a measuring run without a card exits non-zero and prints
nothing."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import bench

ROOT = bench.ROOT
PB = ROOT / "perfbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return bench.load_json(ROOT / "BENCHMARK.json")


def test_keys_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    setup = [m for m in b["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_names_and_units():
    b = _bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in b[group]}) == len(b[group])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in b["workloads"]] + [c["why"] for c in b["configs"]] \
            + [m["layer"] for m in b["per_layer"]] + [c["source"] for c in b["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_resolves_and_reports():
    b = _bench()
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(b["workloads"])
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        f = bench.load_json(ROOT / c["file"])
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert sorted(f["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        cell = bench.Cell(w["name"], seed=1, seconds=1, trace=False, device="cpu")
        assert callable(cell.kind.run)
        assert cell.spec["config"] == w["config"] and cell.spec["traffic"] == w["traffic"]
        assert cell.spec["why"] == w["why"]
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.per_layer()
        assert layers
        for m in layers:
            assert callable(bench.load_module(PB / "metrics" / f"{m['name']}.py").read)
        cell.port_config()


def test_readers_return_nothing_on_nothing():
    for m in _bench()["per_layer"]:
        assert bench.load_module(PB / "metrics" / f"{m['name']}.py").read({}) is None


def test_cell_added_as_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(PB, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    traffic = dict(bench.load_json(PB / "traffic" / "train-b8x256.json"), batch=4)
    (root / "perfbench" / "traffic" / "train-b4x256.json").write_text(json.dumps(traffic))
    (root / "perfbench" / "workloads" / "qwen2-moe-a2.7b.train-b4x256.json").write_text(
        json.dumps({"config": "qwen2-moe-a2.7b", "traffic": "train-b4x256", "why": "a new cell",
                    "limits": {"loss_gap": 1.0}}))
    (root / "perfbench" / "metrics" / "new_metric.train.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "qwen2-moe-a2.7b.train-b4x256", "config": "qwen2-moe-a2.7b",
                           "traffic": "train-b4x256", "chips": 1, "why": "a new cell"})
    for m in b["end_to_end"]:
        if "workloads" in m and "qwen2-moe-a2.7b.train-b8x256" in m["workloads"]:
            m["workloads"].append("qwen2-moe-a2.7b.train-b4x256")
    b["per_layer"].append({"name": "new_metric.train", "unit": "%", "better": "higher",
                           "source": "program_counter", "layer": "trainer",
                           "moves": "train_tokens_per_s",
                           "workloads": ["qwen2-moe-a2.7b.train-b4x256"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.Cell("qwen2-moe-a2.7b.train-b4x256", seed=1, seconds=1, trace=True,
                      device="cpu", root=root)
    assert cell.traffic["batch"] == 4 and cell.traffic["kind"] == "train"
    assert bench.read_metrics(cell, {})["new_metric.train"]["value"] == 1.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_in_sources():
    for path in PB.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(bench.FORBIDDEN), (path, tops)
        assert "benchmarks" not in tops, path
        assert "BENCH_" + "qr.json" not in path.read_text(), path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = ""
    return env


def test_no_jax_loaded_by_a_dry_run():
    code = ("import sys; sys.path[:0] = [{r!r}, {s!r}]\n"
            "from perfbench import bench\n"
            "cell = bench.Cell('xlstm-1.3b.decode-b128-p128', seed=3, seconds=0.5, trace=False,"
            " device='cpu', smoke=True)\n"
            "out = bench.run(cell)\n"
            "print(out['correct'], bench.forbidden_loaded())\n").format(
                r=str(ROOT), s=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split("\n")[-2] == "True []", res.stdout


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "qwen2-moe-a2.7b.train-b8x256",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, env=_env(), timeout=600)


def test_measuring_run_without_card_fails(no_card):
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr


def test_run_without_the_program_fails(tmp_path):
    shutil.copytree(PB, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
