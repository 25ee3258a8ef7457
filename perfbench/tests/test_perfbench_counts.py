"""The benchmark's FLOP and byte counts against hand counts on small
shapes, and its QR count against the program's roofline arithmetic."""

import math

import pytest

from perfbench import bench, counts


def _cfg(cell):
    return bench.Cell(cell, seed=0, seconds=1, trace=False, device="cpu", smoke=True).ref_config()


def test_qr_flops_by_hand():
    # factor 2*4*2^2 - 2/3*2^3, and forming Q the same again
    assert counts.qr_flops(4, 2) == pytest.approx(2 * (32 - 16 / 3))
    assert counts.qr_flops(2, 4) == counts.qr_flops(4, 2)
    assert counts.qr_bytes(10, 3) == 240


@pytest.mark.parametrize("m,n", [(4, 2), (2048, 1408), (1408, 2048), (576, 576), (49152, 576)])
def test_qr_flops_is_factor_plus_form_q_of_program_count(m, n):
    from repro_torch.launch.roofline import qr_flops

    assert counts.qr_flops(m, n) == pytest.approx(2 * qr_flops(m, n))


def test_muon_members_by_hand():
    cfg = _cfg("qwen2-moe-a2.7b.train-b8x256")
    members = counts.muon_members(cfg)
    # 2 periods: wq wk wv wo and the shared SwiGLU (64 x 64, three), the
    # experts' gate, up (64 x 32) and down (32 x 64 -> 64 x 32), 6 each
    assert sorted(set(members)) == [(64, 32), (64, 64)]
    assert members.count((64, 64)) == 2 * (4 + 3)
    assert members.count((64, 32)) == 2 * 3 * 6
    q = counts.qr_step(cfg)
    assert q["flops"] == pytest.approx(14 * counts.qr_flops(64, 64) + 36 * counts.qr_flops(64, 32))
    assert q["roofline_s"] == max(q["flops"] / 67e12, q["bytes"] / 3.35e12)


def test_train_flops_by_hand():
    cfg = _cfg("qwen2-moe-a2.7b.train-b8x256")
    per_period = (4 * 64 * 64          # attention projections
                  + 64 * 6             # router
                  + 3 * 6 * 64 * 32 * 2 / 6   # top-2 of 6 experts
                  + 3 * 64 * 64        # shared experts, fused
                  + 64)                # shared gate
    params = 2 * per_period + 64 * 256  # and the output head
    assert counts.matmul_params(cfg) == pytest.approx(params)
    attn = 2 * 4 * 16 * (8 + 1) / 2 * 4 * 16   # 2 periods, causal QK^T and AV
    assert counts.train_flops(cfg, 2, 8) == pytest.approx(6 * params * 16 + 3 * attn)


def test_xlstm_counts_by_hand():
    cfg = _cfg("xlstm-1.3b.train-b16x256")
    di, h, dh = 128, 2, 64
    mlstm = 64 * 2 * di + 3 * h * dh * dh + di * 2 * h + di * 64
    ffn = 3 * 64 * 64            # round(1.3334 * 64 / 64) * 64 = 64
    slstm = 2 * (64 * 128) + 2 * 32 * 128 + 64 * 64 + ffn
    params = 7 * mlstm + slstm + 256 * 64   # the tied head
    assert counts.matmul_params(cfg) == pytest.approx(params)
    assert counts.train_flops(cfg, 2, 8) == pytest.approx(
        6 * params * 16 + 3 * 7 * 4 * 16 * h * dh * dh)
    state = 7 * (h * dh * dh + h * dh + h + 3 * di) + 64 * (4 + 3)
    assert counts.state_bytes(cfg, 3) == 4 * 3 * state
    n = sum(math.prod(i.shape) for _, i in counts.ref_model.leaves(
        counts.ref_model.param_spec(cfg)))
    assert counts.decode_bytes(cfg, 3) == 2 * n + 2 * 4 * 3 * state
    assert counts.decode_flops(cfg, 3, 100) == pytest.approx(
        2 * params * 3 + 7 * 4 * 3 * h * dh * dh)
