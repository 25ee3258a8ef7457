"""The port's launch layer (``repro_torch.launch.{specs,dryrun,roofline}``)
against the reference's (``repro.launch``), on the CPU.

Twins of ``tests/test_dryrun_launch.py``: the skip policy, the analytic
cost's sanity, a reduced-mesh dry run (on ``meta`` tensors, in-process:
the port has no compiler to lower for host devices), the production mesh
refusing a process without its ranks.  Then a hand count of the
collectives of a tiny cell, and ``roofline_row`` / ``build_table`` /
``format_markdown`` against the reference's on the same artifacts: the
same parameter counts, HBM bytes and model FLOPs (equal), the same
training FLOPs up to ROADMAP C5's gap, and each term equal to the
reference's once the peaks are swapped (rel 1e-12: the H100's in place of
the TPU's).
"""

import json
import math
import types

import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import roofline as jroof
from repro.launch.specs import cell_is_skipped as jskipped
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MeshRules, Spec
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import MeshSizeError, make_production_mesh
from repro_torch.launch.specs import ShapeDtype, cell_is_skipped
from repro_torch.training.train_step import TrainState

_REL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs files in parallel worker
    processes, and these small per-token ops only thrash when each
    process spreads them over every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(a, b):
    return abs(a - b) <= _REL * max(1.0, abs(b))


def test_long_500k_skip_policy():
    """Twin of ``test_long_500k_skip_policy``; every cell's decision is
    the reference's."""
    runs = {a for a in ARCHS if cell_is_skipped(a, "long_500k") is None}
    assert runs == {"jamba-v0.1-52b", "xlstm-1.3b"}
    for a in ARCHS:
        for s in SHAPES:
            assert cell_is_skipped(a, s) == jskipped(a, s)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cost_sane(arch):
    """Twin of ``test_analytic_cost_sane``."""
    cfg = get_config(arch)
    train = roofline.analytic_cell_cost(cfg, SHAPES["train_4k"], "train")
    dec = roofline.analytic_cell_cost(cfg, SHAPES["decode_32k"], "decode")
    assert train.flops > train.model_flops > 0
    assert 0.03 < train.model_flops / train.flops < 1.0
    assert dec.flops < train.flops
    assert train.params_active <= train.params_total
    if cfg.moe is None:
        assert train.params_active == train.params_total


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """smollm-135m at 2 layers on a {data: 2, model: 4} map, train_4k,
    run in-process on meta tensors (one attention chunk: the meta run's
    cost is Python dispatch)."""
    out = tmp_path_factory.mktemp("dryrun")
    rec = dryrun.run_cell("smollm-135m", "train_4k", False, str(out),
                          axes={"data": 2, "model": 4},
                          overrides=dict(n_layers=2, seq_chunk=4096))
    return rec, out


def test_reduced_mesh_dryrun_on_meta(reduced):
    """The artifact has the reference's keys, each field's source named:
    FLOPs from the meta run (fwd + bwd, 0.5-1.0 of the analytic 4 x fwd
    at the rank's batch of 128) plus the optimizer's analytic QR FLOPs,
    argument bytes of the shards, a peak of live bytes, collectives."""
    rec, out = reduced
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["devices"] == 8 and rec["kind"] == "train"
    assert rec["local_batch"] == SHAPES["train_4k"].global_batch // 2
    assert {"memory_analysis", "cost_analysis", "collectives",
            "notes"} <= set(rec)
    cost = rec["cost_analysis"]
    assert cost["source"].startswith("FlopCounterMode")
    cfg = get_config("smollm-135m").scaled(n_layers=2, seq_chunk=4096)
    assert cost["qr_optimizer_flops"] == roofline._qr_optimizer_flops(cfg)
    assert cost["flops"] == cost["model_flops_measured"] + \
        cost["qr_optimizer_flops"]
    analytic = roofline.analytic_cell_cost(
        cfg, ShapeConfig("train_4k", 4096, 128, "train"), "train").flops
    assert 0.5 < cost["model_flops_measured"] / analytic < 1.0
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] > 0
    assert mem["peak_memory_in_bytes"] == (
        mem["argument_size_in_bytes"] + mem["gathered_parameter_bytes"]
        + mem["temp_size_in_bytes"])
    coll = rec["collectives"]
    assert coll["total_weighted_bytes"] >= coll["total_bytes"] > 0
    assert coll["counts"]["all-gather"] > 0
    assert coll["counts"]["reduce-scatter"] > 0
    for field in ("cost_analysis.flops", "memory_analysis", "collectives"):
        assert field in rec["notes"]
    on_disk = json.loads((out / "smollm-135m__train_4k__d2xm4.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))


def test_argument_bytes_are_the_shards(reduced):
    """The argument bytes equal the shard bytes of every state and batch
    leaf under the cell's specs, counted here leaf by leaf."""
    from repro_torch.launch.mesh import make_rules
    from repro_torch.launch.specs import input_specs

    rec, _ = reduced
    axes = {"data": 2, "model": 4}
    cell = input_specs("smollm-135m", "train_4k", make_rules(axes),
                       overrides=dict(n_layers=2, seq_chunk=4096))
    total = 0
    for args, specs in zip(cell.args, cell.in_specs):
        for _, leaf, spec in dryrun._pairs(args, specs):
            n = leaf.dtype.itemsize
            for d, e in zip(leaf.shape, tuple(spec) + (None,) * 8):
                k = 1 if e is None else math.prod(
                    axes[a] for a in ((e,) if isinstance(e, str) else e))
                n *= -(-d // k)
            total += n
    assert rec["memory_analysis"]["argument_size_in_bytes"] == total


def test_production_mesh_raises_without_ranks():
    """Twin of ``test_make_production_mesh_requires_512``: this process
    has no group of 256 ranks."""
    with pytest.raises(MeshSizeError):
        make_production_mesh()
    with pytest.raises(MeshSizeError):
        make_production_mesh(multi_pod=True)


def test_collectives_hand_count():
    """A tiny train cell on {data: 2, model: 2}: a period-stacked (2, 64,
    128) weight and a (256, 64) embedding table, both sharded, and a (64,)
    gain, replicated.  By hand: each sharded parameter (16,384 fp32
    entries, 65,536 bytes) is all-gathered whole and its gradient
    reduce-scattered into a quarter (16,384 bytes); the Muon weight's momentum is all-gathered whole too
    (the table is not a Muon leaf); the gain's gradient is all-reduced
    (256 bytes), and so are the four metrics (16) and the norm (4); the
    batch shards dim 0, so it moves nothing."""
    f32 = torch.float32
    params = {"layers": ({"w": ShapeDtype((2, 64, 128), f32)},),
              "embed": {"table": ShapeDtype((256, 64), f32)},
              "final_norm": {"g": ShapeDtype((64,), f32)}}
    pspecs = {"layers": ({"w": Spec(None, "data", "model")},),
              "embed": {"table": Spec("model", "data")},
              "final_norm": {"g": Spec(None)}}
    batch = {"tokens": ShapeDtype((8, 16), torch.int32)}
    cell = types.SimpleNamespace(
        kind="train", rules=MeshRules({"data": 2, "model": 2}),
        args=(TrainState(params=params, opt=None, ef_error=None), batch),
        in_specs=(TrainState(params=pspecs, opt=None, ef_error=Spec()),
                  {"tokens": Spec("data", None)}))
    got = dryrun.collective_counts(cell)
    assert got["counts"] == {"all-gather": 3, "all-reduce": 3,
                             "reduce-scatter": 2, "all-to-all": 0,
                             "collective-permute": 0}
    assert got["bytes"] == {"all-gather": 3 * 65536, "all-reduce": 276,
                            "reduce-scatter": 2 * 16384, "all-to-all": 0,
                            "collective-permute": 0}
    assert got["total_bytes"] == 3 * 65536 + 276 + 2 * 16384
    assert got["total_weighted_bytes"] == got["total_bytes"]


def _artifact(arch, shape, devices=256, coll=3.5e9, mesh="pod16x16"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "variant":
            "baseline", "status": "ok", "kind": SHAPES[shape].kind,
            "devices": devices,
            "collectives": {"total_bytes": coll / 2,
                            "total_weighted_bytes": coll},
            "cost_analysis": {"flops": 1.0e15},
            "memory_analysis": {"temp_size_in_bytes": 12345}}


def _c5_gap(arch) -> float:
    return jroof._qr_optimizer_flops(jget(arch)) - \
        roofline._qr_optimizer_flops(get_config(arch))


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "train_4k"), ("qwen2-moe-a2.7b", "train_4k"),
    ("xlstm-1.3b", "decode_32k"), ("jamba-v0.1-52b", "long_500k"),
    ("gemma2-9b", "prefill_32k"), ("musicgen-large", "train_4k")])
def test_roofline_row_matches_reference(arch, shape):
    """Every field of the row against the reference's on the same
    artifact: counts and bytes equal, FLOPs up to C5's gap (training
    cells), and each term equal once the peaks are swapped."""
    art = _artifact(arch, shape)
    mine, ref = roofline.roofline_row(art), jroof.roofline_row(art)
    gap = _c5_gap(arch) if SHAPES[shape].kind == "train" else 0.0
    for key in ("arch", "shape", "mesh", "kind", "status", "chips",
                "params_total", "params_active", "hlo_flops_reported",
                "temp_bytes", "collective_bytes_per_shard"):
        assert mine[key] == ref[key], key
    assert _close(mine["hbm_bytes"], ref["hbm_bytes"])
    assert _close(mine["model_flops"], ref["model_flops"])
    assert _close(mine["flops"], ref["flops"] - gap)
    assert _close(mine["compute_s"] * roofline.PEAK_FLOPS["bfloat16"],
                  ref["compute_s"] * jroof.PEAK_FLOPS * mine["flops"]
                  / ref["flops"])
    assert _close(mine["memory_s"] * roofline.HBM_BW,
                  ref["memory_s"] * jroof.HBM_BW)
    assert _close(mine["collective_s"] * roofline.LINK_BW,
                  ref["collective_s"] * jroof.ICI_BW)
    terms = {k: mine[k] for k in ("compute_s", "memory_s", "collective_s")}
    assert mine["dominant"] == max(terms, key=terms.get).replace("_s", "")


def test_link_bandwidth_is_the_nvlink_datasheet_figure():
    assert roofline.LINK_BW == 900e9
    row = roofline.roofline_row(_artifact("olmo-1b", "train_4k",
                                          coll=9.0e9))
    assert _close(row["collective_s"], 0.01)


def test_build_table_and_markdown_match_reference(tmp_path):
    """The same artifact directory (two ok cells, a skipped one, an error
    and a cell of another mesh) through both packages' ``build_table``:
    the same rows in the same order (the port's numbers as the row test
    holds them), the same non-ok rows, and the port's Markdown the
    reference's ``format_markdown`` of the port's rows."""
    arts = [_artifact("olmo-1b", "train_4k"),
            _artifact("xlstm-1.3b", "decode_32k"),
            dict(arch="gemma2-9b", shape="long_500k", mesh="pod16x16",
                 status="skipped", reason="pure full-attention"),
            dict(arch="olmo-1b", shape="prefill_32k", mesh="pod16x16",
                 status="error", error="RuntimeError: boom"),
            _artifact("olmo-1b", "decode_32k", mesh="pod2x16x16")]
    for a in arts:
        (tmp_path / f"{a['arch']}__{a['shape']}__{a['mesh']}.json"
         ).write_text(json.dumps(a))
    mine = roofline.build_table(str(tmp_path))
    ref = jroof.build_table(str(tmp_path))
    assert [(r["arch"], r["shape"], r["status"]) for r in mine] == \
        [(r["arch"], r["shape"], r["status"]) for r in ref]
    assert len(mine) == 4
    for m, r in zip(mine, ref):
        if r["status"] != "ok":
            assert m == r
        else:
            assert m["params_total"] == r["params_total"]
    assert roofline.format_markdown(mine) == jroof.format_markdown(mine)
    multi = roofline.build_table(str(tmp_path), mesh="pod2x16x16")
    assert [r["shape"] for r in multi] == ["decode_32k"]


def test_roofline_main_reads_the_dryrun_artifact(reduced, tmp_path,
                                                 capsys):
    """``python -m repro_torch.launch.roofline`` over the reduced dry
    run's artifact: one ok row, written as JSON and printed."""
    rec, out = reduced
    dest = tmp_path / "roofline.json"
    rows = roofline.main(["--artifacts", str(out), "--mesh", "d2xm4",
                          "--out", str(dest)])
    assert [r["status"] for r in rows] == ["ok"]
    assert json.loads(dest.read_text()) == json.loads(json.dumps(rows))
    assert rows[0]["collective_bytes_per_shard"] == \
        rec["collectives"]["total_weighted_bytes"]
    assert "| smollm-135m | train_4k | ok |" in capsys.readouterr().out


def test_no_a16_raise_left():
    """The table functions no longer raise naming ROADMAP A16."""
    import inspect

    assert "A16" not in inspect.getsource(roofline)
