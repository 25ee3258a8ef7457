"""The controls that the limits were set against, at the configurations'
smoke sizes on the CPU (``perfbench/calibrate.py`` reads them on the card
at each cell's own size): the reference with float8 products in the
program's place fails a cell's limits, and so does a training step on
half of each batch.  In decode the control reads several times what the
program reads on the same seed (in training the program's own readings
at these widths swing from seed to seed, so the ratios are read on the
card, at the cells' sizes)."""

import pytest

from perfbench import bench, calibrate

TRAIN = ["qwen2-moe-a2.7b.train-b8x256", "xlstm-1.3b.train-b16x256"]
DECODE = "xlstm-1.3b.decode-b128-p128"


def _cell(name, **traffic):
    cell = bench.Cell(name, seed=0, seconds=0, trace=False, device="cpu", smoke=True)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("seed", [2147483001, 2147483002, 2147483003])
def test_train_controls_fail_the_limits(name, seed):
    cell = _cell(name, batch=8, seq=64)
    res = dict(calibrate.train_seed(cell, seed, control=True))
    for what in ("control", "half_batch"):
        ok, rows = bench_check(res[what], cell.limits)
        assert not ok, (what, rows)


@pytest.mark.parametrize("seed", [2147483001, 2147483002, 2147483003])
def test_decode_control_fails_the_limit(seed):
    cell = _cell(DECODE, batch=16, weight_scales={"embed.table": 64 ** -0.5})
    res = dict(calibrate.decode_seed(cell, seed, control=True, steps=100))
    ok, rows = bench_check(res["control"], cell.limits)
    assert not ok, rows
    assert res["control"]["mean_gap"] > 3 * res["program"]["mean_gap"], res


def bench_check(readings, limits):
    from perfbench.reference import compare

    return compare.check(readings, limits)
