"""The port's roofline model (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), on the CPU.

``qr_flops``, ``_param_counts`` and every field of ``analytic_cell_cost``
agree at fp64 rounding (rel 1e-12) for all ten architectures over every
shape of ``SHAPES``, with one deliberate difference: a training cell's FLOPs
include QR-Muon's orthogonalization, and the port does not send
period-stacked vectors (norm gains, biases) to Muon (ROADMAP C5), so with
8 or more periods the reference counts exactly ``8 m n^2`` more per such
leaf — the gap is asserted to that figure.  The peaks are H100 data-sheet
figures, not the reference's TPU ones.
"""

import math

import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.launch import roofline as jroof
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.optim.qr_muon import STACKED

_REL = 1e-12


def _close(a, b):
    return abs(a - b) <= _REL * max(1.0, abs(b))


@pytest.mark.parametrize("m,n", [(1, 1), (32, 32), (200, 120), (120, 200),
                                 (4096, 4096), (49152, 576)])
def test_qr_flops_equal_reference(m, n):
    assert _close(roofline.qr_flops(m, n), jroof.qr_flops(m, n))


def test_modeled_seconds_uses_h100_datasheet_peaks():
    assert roofline.PEAK_FLOPS == {"float32": 67e12, "float64": 34e12,
                                   "bfloat16": 989e12}
    assert roofline.HBM_BW == 3.35e12
    assert roofline.modeled_seconds(67e12, 0.0) == 1.0
    assert roofline.modeled_seconds(0.0, 3.35e12, chips=2) == 0.5
    assert roofline.modeled_seconds(34e12, 1.0, dtype="float64") == 1.0
    assert roofline.modeled_seconds(989e12, 1.0, dtype="torch.bfloat16") == 1.0


def _muon_vector_gap(cfg) -> float:
    """8 m n^2 over the period-stacked vectors the reference's
    ``is_muon_param`` sends to Muon and the port's does not (C5)."""
    gap = 0.0
    for name, leaf in roofline._meta_params(cfg).named_parameters():
        names = name.split(".")
        if names[0] != STACKED or leaf.ndim != 2 or min(leaf.shape) < 8:
            continue
        m, n = sorted(leaf.shape, reverse=True)
        gap += 8.0 * m * n * n
    return gap


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_cell_cost_equals_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    gap = _muon_vector_gap(cfg)
    for shape in SHAPES:
        s, js = SHAPES[shape], JSHAPES[shape]
        mine = roofline.analytic_cell_cost(cfg, s, s.kind)
        ref = jroof.analytic_cell_cost(jcfg, js, js.kind)
        assert (mine.params_total, mine.params_active, mine.tokens) == (
            ref.params_total, ref.params_active, ref.tokens)
        assert _close(mine.hbm_bytes, ref.hbm_bytes)
        assert _close(mine.model_flops, ref.model_flops)
        want = ref.flops - (gap if s.kind == "train" else 0.0)
        assert _close(mine.flops, want), (shape, mine.flops, ref.flops, gap)
    # The gap is real exactly where C5 says: 8 or more periods.
    assert (gap > 0) == (cfg.n_periods >= 8 and any(
        leaf.ndim == 2 and min(leaf.shape) >= 8 and n.startswith(STACKED)
        for n, leaf in roofline._meta_params(cfg).named_parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_qr_optimizer_flops_gap_is_c5(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert _close(roofline._qr_optimizer_flops(cfg) + _muon_vector_gap(cfg),
                  jroof._qr_optimizer_flops(jcfg))


def test_smollm_param_count_and_gap():
    """SmolLM-135M: 134,515,008 parameters on the meta device; its 60
    RMSNorm gains (30, 576) are the C5 gap, 2 x 8 x 576 x 30^2."""
    cfg = get_config("smollm-135m")
    assert roofline._param_counts(cfg) == (134_515_008, 134_515_008)
    assert _muon_vector_gap(cfg) == 2 * 8.0 * 576 * 30 ** 2
    assert math.isclose(jroof._qr_optimizer_flops(jget("smollm-135m"))
                        - roofline._qr_optimizer_flops(cfg),
                        2 * 8.0 * 576 * 30 ** 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch):
    """(total, active): MoE counts top_k of its routed experts."""
    mine = roofline._param_counts(get_config(arch))
    assert mine == jroof._param_counts(jget(arch))
    assert (mine[1] < mine[0]) == (get_config(arch).moe is not None)


def test_state_bytes_and_traffic_equal_reference():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jget(arch)
        assert roofline._state_bytes(cfg, 8) == jroof._state_bytes(jcfg, 8)
        assert roofline.n_active_traffic(cfg, 10) == \
            jroof.n_active_traffic(jcfg, 10)


@pytest.mark.parametrize("fn,args", [
    ("roofline_row", ({"arch": "smollm-135m", "shape": "train_4k"},)),
    ("build_table", ("artifacts",)),
    ("main", ()),
])
def test_table_raises_naming_a16(fn, args):
    with pytest.raises(NotImplementedError, match="A16"):
        getattr(roofline, fn)(*args)
