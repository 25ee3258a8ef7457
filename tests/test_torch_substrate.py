"""The port's checkpointing (``repro_torch.checkpoint``) and gradient
codec (``repro_torch.distributed.compression``) against the JAX
package's, on the CPU: twins of ``tests/test_substrate.py``'s checkpoint
and compression tests, plus cross-package checks.

Tolerances: int8 codes and scales equal the reference's bit for bit (the
same fp32 block max, division and round-half-to-even); decoded values
and residuals within one fp32 ulp of the block scale; a checkpoint
written by either package restores bit for bit in the other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.checkpoint import CheckpointManager as RManager
from repro.configs import get_smoke_config as ref_smoke
from repro.distributed import compression as rcomp
from repro.models import init_params as ref_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import (dequantize, ef_compress_tree,
                                     init_error_state, quantize)
from repro_torch.models import params_from_numpy
from worker_threads import share_the_cores  # noqa: F401  (autouse)


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 4, generator=g),
            "b": {"c": torch.arange(5), "d": torch.tensor(3.5)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ----------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    assert mgr.all_steps() == [3, 4]   # gc keeps 2
    restored = mgr.restore(4, _tree(0))
    for got, want in zip(_leaves(restored), _leaves(_tree(4))):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_checkpoint_async_and_metadata(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(10, _tree(1), metadata={"data": {"step": 10, "seed": 0}},
             blocking=False)
    mgr.wait_until_finished()
    assert mgr.latest_step() == 10
    assert mgr.metadata(10)["data"]["step"] == 10


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    os.makedirs(tmp_path / "step_00000002")   # a save that crashed
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(2, _tree(1))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(1))
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"a": torch.zeros(8, 4)})   # missing leaves
    with pytest.raises(ValueError, match="keypath"):
        mgr.restore(1, {"a": torch.zeros(8, 4),
                        "b": {"c": torch.arange(5), "e": torch.tensor(0.)}})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"a": torch.zeros(4, 8),
                        "b": {"c": torch.arange(5), "d": torch.tensor(0.)}})


def test_nonblocking_save_snapshots_before_returning(tmp_path):
    """The train step writes parameters in place: a save that returned
    must hold the values of the moment it was called, however soon the
    tensors change."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree(3)
    before = {"a": tree["a"].clone()}
    mgr.save(5, tree, blocking=False)
    tree["a"].add_(1.0)
    tree["b"]["d"].mul_(2.0)
    mgr.wait_until_finished()
    got = mgr.restore(5, _tree(0))
    assert torch.equal(got["a"], before["a"])
    assert float(got["b"]["d"]) == 3.5


def test_restore_places_on_the_example_and_keeps_numbers(tmp_path):
    """Each leaf lands on the example leaf's dtype (and device); Python
    numbers stay numbers; None holds no leaf."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(6.0).reshape(2, 3), "n": 7, "z": None})
    got = mgr.restore(1, {"x": torch.zeros(2, 3, dtype=torch.float64),
                          "n": 0, "z": None})
    assert got["x"].dtype == torch.float64 and got["n"] == 7
    assert got["z"] is None
    assert torch.equal(got["x"], torch.arange(6.0, dtype=torch.float64
                                              ).reshape(2, 3))


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A parameter tree written by the reference's ``CheckpointManager``
    restores, bit for bit, into the port's tree of the same model (the
    ``params_from_numpy`` structure); and the port's checkpoint of it
    restores into the reference's."""
    cfg = ref_smoke("smollm-135m")
    ref = ref_init(jax.random.PRNGKey(0), cfg)
    RManager(str(tmp_path / "ref")).save(3, ref)
    ours = params_from_numpy(jax.tree.map(np.zeros_like, ref), "cpu").tree()
    got = CheckpointManager(str(tmp_path / "ref")).restore(3, ours)
    want = jax.tree.leaves(ref)
    mine = _leaves(got)
    assert len(mine) == len(want)
    for g, w in zip(mine, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    CheckpointManager(str(tmp_path / "port")).save(4, got)
    back = RManager(str(tmp_path / "port")).restore(4, ref)
    for g, w in zip(jax.tree.leaves(back), want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------- compression


@pytest.mark.parametrize("shape", [(100,), (64, 64), (3, 5, 7)])
def test_quantize_roundtrip_bound(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)) * 10
    codes, scales = quantize(x)
    back = dequantize(codes, scales, shape)
    # int8 symmetric quantization: error <= scale/2 per element
    err = (back - x).abs().max()
    assert float(err) <= float(scales.max()) / 2 + 1e-6
    assert codes.dtype == torch.int8


def test_error_feedback_accumulates_to_unbiased():
    """Sum of decoded updates converges to the sum of true gradients."""
    g = {"w": torch.randn(256, generator=torch.Generator().manual_seed(3))}
    err = init_error_state(g)
    total = torch.zeros(256)
    steps = 50
    for _ in range(steps):
        dec, err = ef_compress_tree(g, err)
        total = total + dec["w"]
    diff = (total / steps - g["w"]).abs().max()
    assert float(diff) < float(g["w"].abs().max()) / 100


@pytest.mark.parametrize("n,scale", [(1, 1.0), (255, 3.0), (256, 1e-3),
                                     (1000, 1e4), (4097, 0.5)])
def test_codes_equal_reference(n, scale):
    """The port's codes and scales are the reference's, bit for bit,
    including exact block-max hits and zero-padded tails."""
    x = (np.random.default_rng(n).standard_normal(n) * scale).astype(
        np.float32)
    x[: n // 3] = np.round(x[: n // 3])          # integer entries
    codes, scales = quantize(torch.from_numpy(x))
    rc, rs = rcomp.quantize(jnp.asarray(x))
    assert np.array_equal(codes.numpy(), np.asarray(rc))
    assert np.array_equal(scales.numpy(), np.asarray(rs))
    back = dequantize(codes, scales, (n,)).numpy()
    assert np.array_equal(back, np.asarray(rcomp.dequantize(rc, rs, (n,))))


def test_ef_compress_tree_matches_reference():
    """Two error-feedback steps over a nested tree: decoded gradients and
    residuals equal the reference's.  (A 2-tuple inside the tree is left
    out: the reference's pair split mistakes it for a (decoded, residual)
    pair, ROADMAP C9; the port keeps its structure.)"""
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((16, 40)).astype(np.float32),
         "b": (rng.standard_normal(300).astype(np.float32),
               rng.standard_normal((2, 3, 5)).astype(np.float32),
               rng.standard_normal(7).astype(np.float32))}
    tg = {"a": torch.from_numpy(g["a"]),
          "b": tuple(torch.from_numpy(x) for x in g["b"])}
    jg = jax.tree.map(jnp.asarray, g)
    te, je = init_error_state(tg), rcomp.init_error_state(jg)
    for _ in range(2):
        td, te = ef_compress_tree(tg, te)
        jd, je = rcomp.ef_compress_tree(jg, je)
        for mine, ref in ((td, jd), (te, je)):
            for x, y in zip(_leaves(mine), jax.tree.leaves(ref)):
                assert np.abs(x.numpy() - np.asarray(y)).max() <= \
                    np.finfo(np.float32).eps * max(
                        1.0, float(np.abs(np.asarray(y)).max()))
        assert isinstance(td["b"], tuple) and len(td["b"]) == 3
    pair = {"p": (torch.ones(3), torch.zeros(2))}
    dec, err = ef_compress_tree(pair, init_error_state(pair))
    assert [tuple(x.shape) for x in dec["p"]] == [(3,), (2,)]
    assert torch.equal(dec["p"][0], torch.ones(3))


@settings(max_examples=20, deadline=None)
@given(scale=st.floats(1e-4, 1e4), seed=st.integers(0, 10_000),
       n=st.integers(1, 2000))
def test_property_quantization_error_bound(scale, seed, n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(seed)) * scale
    codes, scales = quantize(x)
    back = dequantize(codes, scales, (n,))
    err = float((back - x).abs().max())
    assert err <= float(scales.max()) / 2 + 1e-6 * scale
