"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``), on the CPU: the same numpy-seeded inputs through both.

Tolerances, each stated where it is used:

  * a sign-fixed thin Q: the conformance bar ``100 * eps * max(m, n)``
    (``tests/test_conformance.py``), elementwise — the thin Q of a
    full-rank matrix is unique, so two realizations target one matrix;
  * a Muon step's updated params: ``lr * 100 * eps * max(m, n)`` (the
    update is ``lr * scale * O``);
  * AdamW, Newton-Schulz and the LR schedule: fp32 rounding of the same
    formulas (a few ulps).

Also the routing rule ``is_muon_param`` on all ten architectures' leaves,
where the port deliberately differs from the reference on one set of
leaves (ROADMAP C5): the stacked vectors under ``layers``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hypothesis_compat import given, settings, st

from repro import optim as R
from repro.configs import ARCHS, get_config, get_smoke_config
from repro.models import init_params as ref_init_params
from repro_torch import optim as T
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import forward_train, init_params
from worker_threads import share_the_cores  # noqa: F401  (autouse)

EPS32 = float(np.finfo(np.float32).eps)


def _bar(shape, eps=EPS32):
    return 100.0 * eps * max(shape[-2:])


def _randn(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ------------------------------------------------------- qr_orthogonalize


SHAPES = [(64, 64), (256, 64), (64, 256), (96, 40), (40, 96), (130, 50)]


@pytest.mark.parametrize("shape", SHAPES)
def test_qr_orthogonalize_matches_reference(shape):
    """Tolerance: the conformance bar 100 * eps * max(m, n), elementwise."""
    a = _randn(shape, seed=sum(shape))
    ref = np.asarray(R.qr_orthogonalize_2d(jnp.asarray(a)))
    mine = T.qr_orthogonalize_2d(torch.from_numpy(a)).numpy()
    assert mine.shape == shape and mine.dtype == np.float32
    assert np.abs(mine - ref).max() <= _bar(shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_qr_orthogonalize_exact(shape):
    """Twin of ``test_optim.py::test_qr_orthogonalize_exact``."""
    q = T.qr_orthogonalize_2d(torch.from_numpy(_randn(shape))).numpy()
    k = min(shape)
    gram = q.T @ q if shape[0] >= shape[1] else q @ q.T
    np.testing.assert_allclose(gram, np.eye(k), atol=2e-4)


@pytest.mark.parametrize("q_method", ["formq", "solve"])
def test_qr_orthogonalize_stack_matches_reference_per_matrix(q_method):
    """A (3, 96, 40) stack in one call equals the reference's vmap of the
    2-D function, matrix by matrix, within the conformance bar."""
    a = _randn((3, 96, 40), seed=3)
    ref = np.asarray(jax.vmap(lambda x: R.qr_orthogonalize_2d(
        x, q_method=q_method))(jnp.asarray(a)))
    mine = T.qr_orthogonalize_2d(torch.from_numpy(a), q_method=q_method)
    assert np.abs(mine.numpy() - ref).max() <= _bar(a.shape)


def test_qr_vs_ns_same_column_space():
    """Twin of the reference's: QR is exact where Newton-Schulz only
    approximates the column-space projector."""
    m = _randn((128, 32), seed=1)
    qq = T.qr_orthogonalize_2d(torch.from_numpy(m)).numpy()
    qn = T.newton_schulz_orthogonalize(torch.from_numpy(m), steps=12).numpy()
    u, _, _ = np.linalg.svd(m, full_matrices=False)
    proj = u @ u.T
    err_qr = np.abs(qq @ qq.T - proj).max()
    err_ns = np.abs(qn @ qn.T - proj).max()
    assert err_qr < 1e-5 and err_ns < 0.2 and err_qr < err_ns / 100


@pytest.mark.parametrize("shape", [(256, 64), (64, 256), (48, 48)])
def test_newton_schulz_matches_reference(shape):
    """Tolerance 1e-5 absolute: five quintic iterations of fp32 products
    on a unit-norm matrix, summed in different orders."""
    a = _randn(shape, seed=5)
    ref = np.asarray(R.newton_schulz_orthogonalize(jnp.asarray(a)))
    mine = T.newton_schulz_orthogonalize(torch.from_numpy(a)).numpy()
    assert np.abs(mine - ref).max() < 1e-5
    s = np.linalg.svd(mine, compute_uv=False)
    assert s.max() < 1.3 and s.min() > 0.3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_qr_orthogonalize_respects_param_dtype(dtype):
    """Twin of the reference's: low-precision storage returns its dtype,
    accumulated in fp32 and rounded once."""
    m = torch.from_numpy(_randn((96, 40))).to(dtype)
    q = T.qr_orthogonalize_2d(m)
    assert q.dtype == dtype
    q_ref = T.qr_orthogonalize_2d(m.float()).to(dtype)
    assert torch.equal(q, q_ref)
    g = q.float().numpy()
    eps = float(torch.finfo(dtype).eps)
    assert np.abs(g.T @ g - np.eye(40)).max() < 10 * eps


def test_qr_orthogonalize_bf16_matches_reference():
    """bf16 storage through both packages: within the bar of the fp32
    computation plus one bf16 rounding (eps_bf16 / 2 relative)."""
    a = _randn((96, 40), seed=7)
    ref = np.asarray(R.qr_orthogonalize_2d(
        jnp.asarray(a).astype(jnp.bfloat16)).astype(jnp.float32))
    mine = T.qr_orthogonalize_2d(
        torch.from_numpy(a).to(torch.bfloat16)).float().numpy()
    tol = _bar(a.shape) + float(torch.finfo(torch.bfloat16).eps)
    assert np.abs(mine - ref).max() <= tol


def test_qr_orthogonalize_f64_keeps_f64():
    """fp64 stays fp64 (promote(f64, f32) = f64) and matches the
    reference's fp64 result within the fp64 conformance bar."""
    a = _randn((64, 24), seed=0, dtype=np.float64)
    q = T.qr_orthogonalize_2d(torch.from_numpy(a))
    assert q.dtype == torch.float64
    with jax.enable_x64(True):
        ref = np.asarray(R.qr_orthogonalize_2d(jnp.asarray(a)))
    assert ref.dtype == np.float64
    assert np.abs(q.numpy() - ref).max() <= _bar(a.shape,
                                                  np.finfo(np.float64).eps)


@settings(max_examples=10, deadline=None)
@given(m=st.integers(16, 96), n=st.integers(8, 48), seed=st.integers(0, 999))
def test_property_qr_orthogonalize(m, n, seed):
    q = T.qr_orthogonalize_2d(torch.from_numpy(_randn((m, n), seed)))
    k = min(m, n)
    gram = q.T @ q if m >= n else q @ q.T
    assert float(torch.linalg.norm(gram - torch.eye(k))) < 1e-3


# ------------------------------------------------------------ schedule


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 4), (0, 12)])
def test_warmup_cosine_matches_reference(warmup, total):
    """Tolerance: 2 fp32 ulps (both compute in fp32; cos may round
    differently by one)."""
    steps = range(total + 3)
    ref = [float(R.warmup_cosine(s, peak_lr=0.02, warmup_steps=warmup,
                                 total_steps=total)) for s in steps]
    mine = [T.warmup_cosine(s, peak_lr=0.02, warmup_steps=warmup,
                            total_steps=total) for s in steps]
    np.testing.assert_allclose(mine, ref, rtol=2 * EPS32, atol=0)
    as_tensor = T.warmup_cosine(torch.arange(total + 3), peak_lr=0.02,
                                warmup_steps=warmup, total_steps=total)
    np.testing.assert_allclose(as_tensor.numpy(), ref, rtol=2 * EPS32,
                               atol=0)


def test_warmup_cosine_schedule():
    """Twin of ``test_optim.py::test_warmup_cosine_schedule``."""
    lr = [T.warmup_cosine(s, peak_lr=1.0, warmup_steps=10, total_steps=100)
          for s in range(101)]
    assert lr[0] == 0.0 and abs(lr[10] - 1.0) < 1e-6
    assert lr[100] == pytest.approx(0.1, abs=1e-6)
    assert all(a >= b - 1e-9 for a, b in zip(lr[10:], lr[11:]))


# --------------------------------------------------------------- adamw


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal((11,)).astype(np.float32)}


def test_adamw_matches_reference():
    """Two steps; tolerance: fp32 rounding of the same formula (rtol
    4 eps, atol 4 eps)."""
    params, g1, g2 = _tree(0), _tree(1), _tree(2)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = R.adamw_init(rp)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = T.adamw_init(tp)
    for g in (g1, g2):
        rp, rs = R.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                rs, rp, lr=jnp.float32(1e-2))
        tp, ts = T.adamw_update({k: torch.from_numpy(v) for k, v in g.items()},
                                ts, tp, lr=1e-2)
    assert ts.step == int(rs.step) == 2
    for k in params:
        for mine, ref in ((tp[k], rp[k]), (ts.m[k], rs.m[k]),
                          (ts.v[k], rs.v[k])):
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=4 * EPS32, atol=4 * EPS32)


# ---------------------------------------------------------------- muon


def _lm_like(seed=0):
    rng = np.random.default_rng(seed)

    def mk(*s):
        return (0.02 * rng.standard_normal(s)).astype(np.float32)

    params = {"embed": {"table": mk(128, 48)},
              "layers": {"wq": mk(3, 48, 48), "wk": mk(3, 48, 48),
                         "w_in": mk(3, 96, 48), "w_out": mk(3, 48, 96),
                         "g": mk(3, 48)}}
    grads = {"embed": {"table": mk(128, 48)},
             "layers": {k: 5 * mk(*v.shape)
                        for k, v in params["layers"].items()}}
    return params, grads


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("batched", [False, True])
def test_muon_update_matches_reference(batched):
    """One Muon step on the same params and grads, leafwise and batched.
    Params: lr * 100 * eps * max(m, n) (matrix leaves; the AdamW leaves
    at fp32 rounding); momenta and second moments: fp32 rounding."""
    params, grads = _lm_like()
    lr = 0.02
    rp = jax.tree.map(jnp.asarray, params)
    rnew, rstate = R.muon_update(jax.tree.map(jnp.asarray, grads),
                                 R.muon_init(rp), rp, lr=jnp.float32(lr),
                                 batched_ortho=batched)
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    tnew, tstate = T.muon_update(tg, T.muon_init(tp), tp, lr=lr,
                                 batched_ortho=batched, device="cpu")
    rflat = _flat(jax.tree.map(np.asarray, rnew))
    rmu = _flat(jax.tree.map(np.asarray, rstate.mu))
    assert list(tnew) == list(tp) and tstate.step == 1
    for k, ref in rflat.items():
        tol = (lr * _bar(ref.shape) if ref.ndim >= 2 and T.is_muon_param(
            k, ref) else 4 * EPS32)
        assert np.abs(tnew[k].numpy() - ref).max() <= tol, k
        np.testing.assert_allclose(tstate.mu[k].numpy(), rmu[k],
                                   rtol=4 * EPS32, atol=4 * EPS32)
    assert T.is_muon_param("layers.wq", tp["layers.wq"])
    assert not T.is_muon_param("layers.g", tp["layers.g"])


def test_muon_update_is_orthogonal_direction():
    """Twin of the reference's: the applied update is a scaled O."""
    params = {"w": torch.from_numpy(_randn((64, 32), seed=0))}
    grads = {"w": torch.from_numpy(_randn((64, 32), seed=1))}
    new, _ = T.muon_update(grads, T.muon_init(params), params, lr=1.0,
                           momentum=0.0, nesterov=False, method="qr",
                           device="cpu")
    o = (params["w"] - new["w"]).numpy() / np.sqrt(2.0)
    np.testing.assert_allclose(o.T @ o, np.eye(32), atol=2e-4)


def test_muon_update_writes_no_input():
    params, grads = _lm_like(3)
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    before = {k: v.clone() for k, v in tp.items()}
    state = T.muon_init(tp)
    T.muon_update(tg, state, tp, lr=0.02, batched_ortho=True, device="cpu")
    assert all(torch.equal(before[k], tp[k]) for k in tp)
    assert all(not v.any() for v in state.mu.values())


@pytest.mark.parametrize("nesterov", [True, False])
def test_muon_directions_are_what_the_step_orthogonalizes(nesterov,
                                                          monkeypatch):
    """``muon_directions`` returns, bit for bit, the momenta of the step
    and the stacks ``muon_update(batched_ortho=True)`` hands
    ``batched_orthogonalize``; the momenta match the reference's step at
    fp32 rounding."""
    from repro_torch.optim import batched_ortho

    params, grads = _lm_like(2)
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    _, state = T.muon_update(tg, T.muon_init(tp), tp, lr=0.02, device="cpu")
    seen = []
    real = batched_ortho.batched_orthogonalize

    def record(leaves, **kw):
        seen.append(list(leaves))
        return real(leaves, **kw)

    monkeypatch.setattr(batched_ortho, "batched_orthogonalize", record)
    _, after = T.muon_update(tg, state, tp, lr=0.02, nesterov=nesterov,
                             batched_ortho=True, device="cpu")
    mu, dirs = T.muon_directions(tg, state, tp, nesterov=nesterov)
    assert list(dirs) == [k for k, p in tp.items() if T.is_muon_param(k, p)]
    assert len(seen) == 1 and len(seen[0]) == len(dirs)
    assert all(torch.equal(a, b) for a, b in zip(seen[0], dirs.values()))
    assert all(torch.equal(mu[k], after.mu[k]) for k in mu)

    rp = jax.tree.map(jnp.asarray, params)
    rg = jax.tree.map(jnp.asarray, grads)
    rstate = R.muon_init(rp)
    for _ in range(2):
        _, rstate = R.muon_update(rg, rstate, rp, lr=jnp.float32(0.02),
                                  nesterov=nesterov)
    rmu = _flat(jax.tree.map(np.asarray, rstate.mu))
    for k in mu:
        np.testing.assert_allclose(mu[k].numpy(), rmu[k], rtol=4 * EPS32,
                                   atol=4 * EPS32)


@pytest.mark.parametrize("opt", ["muon-qr", "muon-ns", "adamw"])
def test_optimizers_reduce_loss(opt):
    """Twin of ``test_optim.py::test_optimizers_reduce_loss`` on the
    port's olmo-1b smoke model."""
    cfg = t_smoke("olmo-1b")
    model = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 64))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 64)))}

    def loss_fn():
        lg, aux = forward_train(model, batch, cfg)
        lp = torch.log_softmax(lg.float(), -1)
        return -torch.gather(lp, -1, batch["labels"][..., None]).mean() + aux

    names = [k for k, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    state = (T.adamw_init({k: p.detach() for k, p in params.items()})
             if opt == "adamw" else
             T.muon_init({k: p.detach() for k, p in params.items()}))
    l0 = float(loss_fn().detach())
    for _ in range(5):
        grads = dict(zip(names, torch.autograd.grad(loss_fn(),
                                                    list(params.values()))))
        cur = {k: p.detach() for k, p in params.items()}
        if opt == "adamw":
            new, state = T.adamw_update(grads, state, cur, lr=1e-3)
        else:
            new, state = T.muon_update(grads, state, cur, lr=0.02,
                                       method=opt.split("-")[1],
                                       device="cpu")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
    l1 = float(loss_fn().detach())
    assert l1 < l0 - 0.5, (opt, l0, l1)


def test_muon_update_device_rules(tmp_path):
    """The step runs on "cuda" unless asked; never on a device its
    tensors are not on; ``qr_shard_leaves`` (ROADMAP A21) runs: without
    a mesh and on a (1, 1) mesh of one gloo rank its update is the
    leafwise one's bit for bit (on the CPU each stack takes the
    reference's realization), the mesh run keeps every leaf's placement,
    and on DTensor leaves it needs the mesh's rules."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding

    params, grads = _lm_like()
    tp = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    tg = {k: torch.from_numpy(v) for k, v in _flat(grads).items()}
    state = T.muon_init(tp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.muon_update(tg, state, tp, lr=0.02)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.batched_orthogonalize([tp["layers.wq"]])
    want, _ = T.muon_update(tg, state, tp, lr=0.02, device="cpu")
    got, _ = T.muon_update(tg, state, tp, lr=0.02, qr_shard_leaves=True,
                           device="cpu")
    assert all(torch.equal(got[k], want[k]) for k in want)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        rules = sharding.MeshRules(mesh)
        specs = sharding.param_specs(tp, rules)
        place = lambda tree: sharding.distribute_tree(tree, specs, mesh)  # noqa: E731
        mstate = sharding.distribute_tree(
            state, sharding.state_specs(tp, specs, state, rules), mesh)
        new, _ = T.muon_update(place(tg), mstate, place(tp), lr=0.02,
                               qr_shard_leaves=True, rules=rules,
                               device="cpu")
        with pytest.raises(ValueError, match="rules"):
            T.muon_update(place(tg), mstate, place(tp), lr=0.02,
                          qr_shard_leaves=True, device="cpu")
        for k in want:
            assert isinstance(new[k], DTensor)
            assert torch.equal(sharding.full_tensor(new[k]), want[k]), k
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- routing and C5


def _leaf_shapes(arch, smoke):
    """The reference's parameter leaves of ``arch`` as (dotted name,
    ShapeDtypeStruct), through ``jax.eval_shape`` — no arrays."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    tree = jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0), cfg))
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.append((path, ".".join(names), leaf))
    return cfg, out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_is_muon_param_matches_reference_off_c5(arch, smoke):
    """On every leaf of every architecture the port routes as the
    reference does, except the C5 set: a leaf under ``layers`` whose
    per-period rank is below 2 (norm gains, biases), which the port
    never sends to Muon."""
    cfg, leaves = _leaf_shapes(arch, smoke)
    c5 = 0
    for path, name, leaf in leaves:
        ref = R.is_muon_param(path, leaf)
        mine = T.is_muon_param(name, leaf)
        if name.startswith("layers.") and leaf.ndim - 1 < 2:
            assert not mine, name
            c5 += ref
        else:
            assert mine == ref, (name, leaf.shape)
    if cfg.n_periods < 8:
        assert c5 == 0       # the reference's own test sees no difference


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2.5-32b", "gemma2-9b"])
def test_c5_reference_routes_stacked_norm_gains_to_muon(arch):
    """ROADMAP C5: at full depth (>= 8 periods) the reference's
    ``is_muon_param`` sends the stacked RMSNorm / LayerNorm gains to Muon
    — its own docstring says norms do not — and the port does not."""
    cfg, leaves = _leaf_shapes(arch, smoke=False)
    assert cfg.n_periods >= 8
    gains = [(p, n, l) for p, n, l in leaves
             if n.startswith("layers.") and "norm" in n]
    assert gains
    assert any(R.is_muon_param(p, l) for p, _, l in gains)
    assert not any(T.is_muon_param(n, l) for _, n, l in gains)


def test_smollm_full_width_routes_210_matrices():
    """SmolLM-135M at full width: 7 Muon leaves of 30 periods, 210
    matrices in three shape classes, planned for the card."""
    _, leaves = _leaf_shapes("smollm-135m", smoke=False)
    muon = [(tuple(l.shape), np.float32) for _, n, l in leaves
            if T.is_muon_param(n, l)]
    assert len(muon) == 7
    plan = T.plan_batched_ortho(muon, backend="cuda")
    got = {(c.key.m, c.key.n): (len(c.members), c.route, c.method,
                                c.dispatch_mode) for c in plan.classes}
    assert got == {(576, 576): (60, "batched", "tiled", "megakernel"),
                   (1536, 576): (90, "batched", "tiled", "wavefront"),
                   (576, 192): (60, "batched", "geqrf_ht", None)}
    assert plan.n_matrices == 210 and plan.dispatches == 3
    assert plan.leafwise_matrices == 0
