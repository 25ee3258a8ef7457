"""The port's training meshes (``repro_torch.distributed.sharding``'s
rules and placements, ``repro_torch.launch.mesh``, mesh training through
``Trainer(mesh=...)``) against the JAX package's, on the CPU.

In process: the spec functions against the reference's on every
architecture's full-width parameter tree (shapes only, from
``jax.eval_shape``), on the production meshes (a ``jax.sharding.
AbstractMesh`` on the reference's side, an ``{axis: size}`` mapping on
the port's) and on (2, 4), (4, 2) and (1, 1), tensor parallelism on and
off: the same spec for every leaf, exactly.

Two runs per module, started together and shared by the tests:

  * the port: eight gloo ranks on a (4, 2) ``("data", "model")`` mesh,
    each a process started from this file's rank program, joined through
    a ``file://`` store under ``tmp_path``;
  * the reference: one process with eight forced host devices on
    ``jax.make_mesh((4, 2), ("data", "model"))``.

They compare: every rank's local shard of every carried olmo-1b smoke
leaf against the reference's shard on the device at the same mesh
coordinate (bit for bit); six steps of the drill configuration (olmo-1b
smoke in fp32, batch 8 x 32) with AdamW and with QR-Muon plus
``qr_shard_leaves`` from the reference's weights (losses within 1e-5
relative, the port's single-process bar against the reference); the
activation constraints' placements; and the twin of
``tests/test_distributed_muon.py`` (QR-Muon with the collective TSQR as
orthogonalizer on FSDP-sharded momentum: orthonormal to 1e-3 and within
1e-3 of the single-device orthogonalizer, the reference's bars).
"""

import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS, get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.distributed import sharding as R
from repro.launch import mesh as RM
from repro.models import init_params as ref_init_params
from repro.models.transformer import init_caches as ref_init_caches
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import muon_init as ref_muon_init
from repro_torch.distributed import sharding as T
from repro_torch.launch import mesh as TM
from repro_torch.optim import AdamWState, MuonState, is_muon_param

ROOT = Path(__file__).resolve().parents[1]
WORLD, MESH = 8, (4, 2)
STEPS = 6
LOSS_RTOL = 1e-5
ARCH = "olmo-1b"

# (id, reference mesh, port mesh): the production meshes through
# make_rules, and three small ones.
MESHES = {
    "single_pod": (AbstractMesh((16, 16), ("data", "model")),
                   TM.axis_map(TM.SINGLE_POD)),
    "multi_pod": (AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                  TM.axis_map(TM.MULTI_POD)),
    "2x4": (AbstractMesh((2, 4), ("data", "model")), {"data": 2, "model": 4}),
    "4x2": (AbstractMesh((4, 2), ("data", "model")), {"data": 4, "model": 2}),
    "1x1": (AbstractMesh((1, 1), ("data", "model")), {"data": 1, "model": 1}),
}


def _rules(mesh_id, tp):
    ref_mesh, port_mesh = MESHES[mesh_id]
    return (dataclasses.replace(RM.make_rules(ref_mesh), tp_enabled=tp),
            dataclasses.replace(TM.make_rules(port_mesh), tp_enabled=tp))


def _key(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                 for k in path)


def _ref_flat(spec_tree):
    """``{path: spec as a tuple}`` of a reference spec tree."""
    return {_key(p): tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))}


def _port_flat(spec_tree):
    return {names: tuple(s) for names, s in T.leaves_with_names(spec_tree)}


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = get_config(arch)
    return jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0), cfg))


def _dotted(tree):
    """A reference tree as the port's flat ``{dotted name: leaf}``."""
    return {".".join(_key(p)): leaf
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------ spec rules


@pytest.mark.parametrize("tp", [True, False], ids=["tp", "no_tp"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_state_specs_match_reference(arch, mesh_id, tp):
    """``param_specs`` on the full-width tree (nested, and flat by dotted
    name) and ``state_specs`` on the Muon and AdamW states of that tree:
    the reference's spec on every leaf."""
    ref_rules, rules = _rules(mesh_id, tp)
    shapes = _shapes(arch)
    ref_specs = R.param_specs(shapes, ref_rules)
    want = _ref_flat(ref_specs)
    assert _port_flat(T.param_specs(shapes, rules)) == want
    flat = _dotted(shapes)
    port_specs = T.param_specs(flat, rules)
    assert {tuple(k.split(".")): tuple(v) for k, v in port_specs.items()} \
        == want
    for init, port_state in (
            (ref_muon_init, lambda s: MuonState(step=0, mu=_dotted(s.mu),
                                                nu=_dotted(s.nu))),
            (ref_adamw_init, lambda s: AdamWState(step=0, m=_dotted(s.m),
                                                  v=_dotted(s.v)))):
        state = jax.eval_shape(init, shapes)
        ref = _ref_flat(R.state_specs(shapes, ref_specs, state, ref_rules))
        got = _port_flat(T.state_specs(flat, port_specs, port_state(state),
                                       rules))
        ref = {k: v for k, v in ref.items() if k[0] != "step"}
        assert {k: v for k, v in got.items() if k[0] != "step"} == ref


BATCHES = [{"tokens": (8, 512), "labels": (8, 512)},
           {"tokens": (1, 16), "labels": (1, 16)},
           {"embeds": (4, 32, 64), "labels": (4, 32)},
           {"tokens": (3, 7)}, {"scalar": ()}]


@pytest.mark.parametrize("tp", [True, False], ids=["tp", "no_tp"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_batch_specs_match_reference(mesh_id, tp):
    """Batch over the batch axes, the batch-1 sequence fallback, and
    replication where nothing divides."""
    ref_rules, rules = _rules(mesh_id, tp)
    for b in BATCHES:
        sds = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in b.items()}
        want = {k: tuple(v) for k, v in R.batch_specs(sds, ref_rules).items()}
        got = {k: tuple(v) for k, v in T.batch_specs(sds, rules).items()}
        assert got == want, (b, got, want)
    rules1 = TM.make_rules({"data": 2, "model": 4})
    one = T.batch_specs({"tokens": torch.zeros(1, 16)}, rules1)
    assert one["tokens"] == T.Spec(None, "data")


@pytest.mark.parametrize("batch", [1, 4], ids=["b1", "b4"])
@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_id, batch):
    """``cache_specs`` on the reference's decode-cache shapes (its
    ``init_caches``): batch over data, heads over model, the sequence
    for a batch that does not divide."""
    ref_rules, rules = _rules(mesh_id, True)
    cfg = get_config(arch)
    caches = jax.eval_shape(lambda: ref_init_caches(cfg, batch, 256))
    assert _port_flat(T.cache_specs(caches, rules)) == \
        _ref_flat(R.cache_specs(caches, ref_rules))


def test_rules_read_sizes_of_every_mesh_kind():
    """``MeshRules`` reads an ``{axis: size}`` mapping as the reference's
    reads a mesh (the reference's also reads an ``AbstractMesh``);
    ``make_rules`` folds the pod axis into data."""
    for mesh_id, (ref_mesh, mesh) in MESHES.items():
        ref_rules, rules = _rules(mesh_id, True)
        assert (rules.data_size, rules.model_size, rules.batch_size_eff,
                rules.data_spec(), rules.batch_spec()) == (
            ref_rules.data_size, ref_rules.model_size,
            ref_rules.batch_size_eff, ref_rules.data_spec(),
            ref_rules.batch_spec()), mesh_id
    assert TM.make_rules(TM.axis_map(TM.MULTI_POD)).data_axes == ("pod", "data")
    with pytest.raises(TM.MeshSizeError, match="256 ranks"):
        TM.make_production_mesh(device_type="cpu")


def test_placements_follow_the_spec():
    """One placement per mesh dim; a dim split over two axes takes both,
    major first in mesh order; reversed or repeated axes are refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = TM.axis_map(TM.MULTI_POD)
    assert T.placements(T.Spec(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert T.placements(T.Spec(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert T.placements(T.Spec(), mesh) == (Replicate(),) * 3
    tree = T.tree_placements({"a": T.Spec("model"), "b": (T.Spec(),)}, mesh)
    assert tree == {"a": (Replicate(), Replicate(), Shard(0)),
                    "b": ((Replicate(),) * 3,)}
    with pytest.raises(ValueError, match="order"):
        T.placements(T.Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        T.placements(T.Spec("data", "data"), mesh)


def test_constraints_pass_plain_tensors_through():
    """Outside a policy, or on a plain tensor inside one, the activation
    constraints return their input."""
    x = torch.zeros(4, 8, 16)
    assert T.constrain_hidden(x) is x and T.constrain_logits(x) is x
    with T.activation_policy(TM.make_rules({"data": 2, "model": 2})):
        assert T.constrain_hidden(x) is x and T.constrain_logits(x) is x


# --------------------------------------------------------- on the ranks


_RANK_PROGRAM = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, store, out, weights = (int(sys.argv[1]), int(sys.argv[2]),
                                        sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import tsqr
    from repro_torch.data import DataConfig
    from repro_torch.distributed import sharding
    from repro_torch.models import init_params
    from repro_torch.optim import muon_init, muon_update, qr_orthogonalize_2d
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    rules = sharding.MeshRules(mesh)
    res = {"coord": np.array(mesh.get_coordinate())}
    cfg = get_smoke_config("olmo-1b").scaled(dtype="float32")
    flat = dict(np.load(weights))

    def carried():
        # The port's tree of the config, holding the reference's weights.
        params = init_params(torch.Generator().manual_seed(0), cfg)
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(torch.from_numpy(flat[k]))
        return params

    # Shards of the carried weights.
    named = {k: p.detach() for k, p in carried().named_parameters()}
    assert set(named) == set(flat)
    placed = sharding.distribute_tree(named, sharding.param_specs(named, rules), mesh)
    for k, d in placed.items():
        res["shard/" + k] = d.to_local().numpy()
        res["whole_ok/" + k] = np.array([torch.equal(d.full_tensor(), named[k])])
    # The activation constraints on a replicated (8, 16, 6) DTensor.
    x = torch.arange(8 * 16 * 6, dtype=torch.float32).reshape(8, 16, 6)
    xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
    with sharding.activation_policy(rules):
        h = sharding.constrain_hidden(xd)
        lg = sharding.constrain_logits(xd)
    res["hidden_places"] = np.array([str(p) for p in h.placements])
    res["hidden_local"] = h.to_local().numpy()
    res["logits_places"] = np.array([str(p) for p in lg.placements])
    res["logits_local"] = lg.to_local().numpy()
    # The MoE and decode constraints on replicated DTensors.
    rep = lambda t: DTensor.from_local(t, mesh, [Replicate(), Replicate()])
    with sharding.activation_policy(rules):
        placed = {
            "expert": sharding.constrain_expert_stack(rep(torch.arange(
                4 * 8 * 6, dtype=torch.float32).reshape(4, 8, 6))),
            "token": sharding.constrain_token_stack(rep(torch.arange(
                8 * 6, dtype=torch.float32).reshape(8, 6))),
            "scores": sharding.constrain_decode_scores(rep(torch.arange(
                8 * 2 * 2 * 6, dtype=torch.float32).reshape(8, 2, 2, 1, 6)))}
    for name, t in placed.items():
        res[name + "_places"] = np.array([str(p) for p in t.placements])
        res[name + "_local"] = t.to_local().numpy()
    # Six steps of the drill configuration from the carried weights.
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    for name, kw in (("adamw", dict(optimizer="adamw", lr=1e-3)),
                     ("muon", dict(optimizer="muon-qr", lr=0.02,
                                   qr_shard_leaves=True))):
        tr = Trainer(cfg, TrainConfig(**kw),
                     RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                     data, device="cpu", mesh=mesh, rules=rules,
                     log_fn=lambda s: None, params=carried())
        if name == "muon":
            # The parameters after the first update (step 2), whole.
            tr.run(stop_at=2)
            for k, p in tr.state.params.named_parameters():
                res["first/" + k] = sharding.full_tensor(p.detach()).numpy()
        res["losses_" + name] = np.array([m["loss"] for m in tr.run()["history"]])
    # Microbatches of each rank's shard and the gradient codec on the
    # mesh, against the same run without a mesh (every rank runs it).
    for name, m in (("codec_free", None), ("codec_mesh", mesh)):
        tr = Trainer(cfg, TrainConfig(optimizer="adamw", lr=1e-3, microbatch=4,
                                      grad_compression=True),
                     RunConfig(total_steps=4, warmup_steps=1, log_every=1),
                     data, device="cpu", mesh=m, log_fn=lambda s: None,
                     params=carried())
        res["losses_" + name] = np.array([h["loss"] for h in tr.run()["history"]])
    # smollm-135m smoke at 4 periods: its stacks shard over "data" and
    # their columns over "model" (the layer-sharded QR for real).
    scfg = get_smoke_config("smollm-135m").scaled(dtype="float32", n_layers=4)
    sflat = dict(np.load(weights.replace("weights", "smollm")))
    sp = init_params(torch.Generator().manual_seed(0), scfg)
    with torch.no_grad():
        for k, p in sp.named_parameters():
            p.copy_(torch.from_numpy(sflat[k]))
    tr = Trainer(scfg, TrainConfig(optimizer="muon-qr", lr=0.02,
                                   qr_shard_leaves=True),
                 RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                 DataConfig(vocab_size=scfg.vocab_size, seq_len=32,
                            global_batch=8),
                 device="cpu", mesh=mesh, rules=rules, log_fn=lambda s: None,
                 params=sp)
    res["losses_smollm_muon"] = np.array([m["loss"] for m in tr.run()["history"]])
    # Twin of test_distributed_muon.py: the collective TSQR orthogonalizes
    # (512, 64) momentum whose rows are sharded over eight ranks.
    line = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    group = line.get_group(0)

    def tsqr_orth(m2d):
        q, r = tsqr.distributed_qr(m2d.to_local(), group)
        signs = torch.where(torch.diagonal(r) >= 0, 1.0, -1.0)
        return DTensor.from_local(q * signs[None, :], line, [Shard(0)],
                                  run_check=False)

    g = np.random.default_rng(1).standard_normal((512, 64)).astype(np.float32)
    w = np.random.default_rng(0).standard_normal((512, 64)).astype(np.float32)
    dt = lambda a: sharding.distribute(torch.from_numpy(a), sharding.Spec("data", None), line)
    p, gr = {"w": dt(w)}, {"w": dt(g)}
    new, _ = muon_update(gr, muon_init(p), p, lr=1.0, momentum=0.0,
                         nesterov=False, orthogonalize_fn=tsqr_orth, device="cpu")
    res["dmuon_delta"] = ((p["w"] - new["w"]).full_tensor() / np.sqrt(512 / 64)).numpy()
    res["dmuon_ref"] = qr_orthogonalize_2d(torch.from_numpy(g)).numpy()
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()
""")


_REFERENCE_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.data import DataConfig
    from repro.distributed.sharding import (MeshRules, activation_policy,
                                            param_specs, tree_shardings)
    from repro.training import RunConfig, TrainConfig, Trainer
    out, weights = sys.argv[1], sys.argv[2]
    # Auto axes: GSPMD propagation, which the reference's code was
    # written for (this jax's make_mesh defaults to explicit axes).
    mesh = jax.make_mesh((4, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = MeshRules(mesh=mesh, data_axes=("data",))
    cfg = get_smoke_config("olmo-1b").scaled(dtype="float32")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    flat = dict(np.load(weights))
    res = {}
    for name, kw in (("adamw", dict(optimizer="adamw", lr=1e-3)),
                     ("muon", dict(optimizer="muon-qr", lr=0.02,
                                   qr_shard_leaves=True))):
        tr = Trainer(cfg, TrainConfig(**kw),
                     RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                     data, mesh=mesh, rules=rules, log_fn=lambda s: None)
        start = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
                 np.asarray(v) for p, v in
                 jax.tree_util.tree_leaves_with_path(tr.state.params)}
        assert all(np.array_equal(start[k], flat[k]) for k in flat), name
        if name == "adamw":
            # The trainer's placed parameters: each device's shard, by the
            # device's mesh coordinate.
            coords = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
                      for d in mesh.devices.flat}
            for p, v in jax.tree_util.tree_leaves_with_path(tr.state.params):
                key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                for s in v.addressable_shards:
                    c = coords[s.device.id]
                    res[f"shard/{c[0]}_{c[1]}/{key}"] = np.asarray(s.data)
        # The same run on one device: the reference's own spread.
        one = Trainer(cfg, TrainConfig(**kw),
                      RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                      data, log_fn=lambda s: None)
        if name == "muon":
            # The parameters after the first update (step 2).
            with mesh, activation_policy(rules):
                tr.run(stop_at=2)
            one.run(stop_at=2)
            for run, prefix in ((tr, "first/"), (one, "one_device_first/")):
                for p, v in jax.tree_util.tree_leaves_with_path(run.state.params):
                    key = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
                    res[prefix + key] = np.asarray(v)
        with mesh, activation_policy(rules):
            res["losses_" + name] = np.array([m["loss"] for m in tr.run()["history"]])
        res["one_device_" + name] = np.array([m["loss"] for m in one.run()["history"]])
    scfg = get_smoke_config("smollm-135m").scaled(dtype="float32", n_layers=4)
    tr = Trainer(scfg, TrainConfig(optimizer="muon-qr", lr=0.02,
                                   qr_shard_leaves=True),
                 RunConfig(total_steps=6, warmup_steps=1, log_every=1),
                 DataConfig(vocab_size=scfg.vocab_size, seq_len=32,
                            global_batch=8),
                 mesh=mesh, rules=rules, log_fn=lambda s: None)
    sflat = dict(np.load(weights.replace("weights", "smollm")))
    start = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
             np.asarray(v) for p, v in
             jax.tree_util.tree_leaves_with_path(tr.state.params)}
    assert all(np.array_equal(start[k], sflat[k]) for k in sflat)
    with mesh, activation_policy(rules):
        res["losses_smollm_muon"] = np.array([m["loss"] for m in tr.run()["history"]])
    np.savez(out, **res)
""")


def _env():
    # One thread a process: nine processes share the CPU.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _carried_weights(path, cfg):
    """The reference trainer's starting weights (``init_params`` at its
    seed 0), flat by dotted name: what both runs start from."""
    tree = ref_init_params(jax.random.PRNGKey(0), cfg)
    flat = {k: np.asarray(v) for k, v in _dotted(tree).items()}
    np.savez(path, **flat)
    return flat


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs, started together: ``(ranks, reference, weights)``."""
    tmp = tmp_path_factory.mktemp("mesh")
    weights = str(tmp / "weights.npz")
    flat = _carried_weights(weights, ref_smoke(ARCH).scaled(dtype="float32"))
    _carried_weights(str(tmp / "smollm.npz"), ref_smoke("smollm-135m").scaled(
        dtype="float32", n_layers=4))
    ref_out = str(tmp / "reference.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE_PROGRAM, ref_out, weights],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    rank_out = [str(tmp / f"rank{r}.npz") for r in range(WORLD)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(r), str(WORLD),
         str(tmp / "store"), rank_out[r], weights],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [dict(np.load(f)) for f in rank_out], dict(np.load(ref_out)), flat


def test_every_rank_holds_the_references_shard(runs):
    """Each rank's shard of every carried leaf equals, bit for bit, the
    reference's shard on the device at the same (data, model) coordinate,
    and gathers back to the whole leaf."""
    ranks, ref, flat = runs
    coords = set()
    for r in ranks:
        c = tuple(int(i) for i in r["coord"])
        coords.add(c)
        for k in flat:
            want = ref[f"shard/{c[0]}_{c[1]}/{k}"]
            got = r["shard/" + k]
            assert got.shape == want.shape and np.array_equal(got, want), k
            assert bool(r["whole_ok/" + k][0]), k
    assert coords == {(i, j) for i in range(MESH[0]) for j in range(MESH[1])}


@pytest.mark.parametrize("run", ["adamw", "smollm_muon", "muon"])
def test_mesh_training_matches_reference(runs, run):
    """Six steps on the (4, 2) mesh from the reference's weights and
    batches, every rank's losses equal: within 1e-5 relative of the
    reference's 8-device run (fp32) for olmo-1b with AdamW and for
    smollm-135m at 4 periods with QR-Muon and ``qr_shard_leaves`` (its
    stacks layer-sharded over "data", columns over "model").

    olmo-1b's QR-Muon momenta are singular (its non-parametric layer
    norm projects the mean out of every input and output gradient, see
    :func:`test_first_muon_update_matches_reference`), so the last Q
    column of each matrix is rounding noise and the reference's own
    8-device and one-device runs part by ~1e-4 once the first update
    acts (step 3): there the first two steps hold 1e-5, every step stays
    within twice the reference's own spread, and the update itself is
    held to 1e-5 on the columns the momenta determine."""
    ranks, ref, _ = runs
    got, want = ranks[0]["losses_" + run], ref["losses_" + run]
    assert len(want) == STEPS
    for r in ranks:
        assert np.array_equal(r["losses_" + run], got)
    if run != "muon":
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
        return
    np.testing.assert_allclose(got[:2], want[:2], rtol=LOSS_RTOL, atol=0)
    spread = np.abs(ref["one_device_muon"] - want) / np.abs(want)
    assert spread.max() > LOSS_RTOL
    assert (np.abs(got - want) / np.abs(want)).max() <= 2 * spread.max()


def _tf32(x):
    """``x`` (fp32) rounded to TF32's 10-bit mantissa, to nearest."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((b + 0x1000) & ~0x1FFF).view(np.float32)


def _determined(update):
    """A stack of Muon updates in the tall orientation the QR factors,
    without its last column (float64)."""
    d = update.astype(np.float64)
    if d.shape[-2] < d.shape[-1]:
        d = np.swapaxes(d, -1, -2)
    return d[..., :-1]


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_first_muon_update_matches_reference(runs):
    """olmo-1b's first QR-Muon update (step 2) on the (4, 2) mesh against
    the reference's 8-device run, leaf by leaf, within 1e-5 relative on
    every column but the last of each matrix (in the tall orientation the
    QR factors); an update rounded to TF32 (what an orthogonalization of
    TF32 grade returns at best) fails that bar on every leaf, and the
    reference's own one-device run meets it.

    The last column is left out because the momenta determine it only up
    to rounding: olmo's non-parametric layer norm makes every input and
    every output gradient of a Muon matrix sum to zero over its features,
    so each momentum is singular with its last column dependent on the
    others (fp64 condition numbers 1e7-2e9), and that column's Q column
    (its sign, or for a rectangular matrix its direction) follows the
    rounding of the run.  QR's first k Q columns depend only on the first
    k columns of the momentum, so the others are determined."""
    ranks, ref, flat = runs
    muon = [k for k, v in flat.items()
            if is_muon_param(k, torch.empty(v.shape))]
    assert len(muon) == 7, muon
    for r in ranks:
        assert all(np.array_equal(r["first/" + k], ranks[0]["first/" + k])
                   for k in flat)
    for k in muon:
        start = flat[k]
        got = _determined(start - ranks[0]["first/" + k])
        want = _determined(start - ref["first/" + k])
        own = _determined(start - ref["one_device_first/" + k])
        ctrl = _determined(_tf32(start - ranks[0]["first/" + k]))
        assert _rel(got, want) <= LOSS_RTOL, (k, _rel(got, want))
        assert _rel(own, want) <= LOSS_RTOL, (k, _rel(own, want))
        assert _rel(ctrl, want) > LOSS_RTOL, (
            "the TF32 control passed", k, _rel(ctrl, want))


def test_microbatches_and_codec_on_the_mesh(runs):
    """AdamW with microbatches of 4 rows of the global batch of 8 (two
    microbatches: each rank's shard of 2 rows split in two) and the int8 error-feedback codec on whole gradients: the mesh run's
    losses within 1e-4 relative of the same run without a mesh (the
    codec's bar against the reference: a code may round the other way on
    an ulp of gradient)."""
    ranks, _, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["losses_codec_mesh"],
                                   r["losses_codec_free"], rtol=1e-4, atol=0)
        assert np.array_equal(r["losses_codec_mesh"],
                              ranks[0]["losses_codec_mesh"])


def test_activation_constraints_place_dtensors(runs):
    """Under the policy a replicated (8, 16, 6) DTensor is redistributed:
    hidden states batch over "data"; logits batch over "data" and the
    last dim over "model"."""
    ranks, _, _ = runs
    x = np.arange(8 * 16 * 6, dtype=np.float32).reshape(8, 16, 6)
    for r in ranks:
        i, j = (int(c) for c in r["coord"])
        assert list(r["hidden_places"]) == ["S(0)", "R"]
        assert np.array_equal(r["hidden_local"], x[2 * i:2 * i + 2])
        assert list(r["logits_places"]) == ["S(0)", "S(2)"]
        assert np.array_equal(r["logits_local"],
                              x[2 * i:2 * i + 2, :, 3 * j:3 * j + 3])


def test_moe_and_decode_constraints_place_dtensors(runs):
    """MoE buffers (4, 8, 6): experts over "model"; flat tokens (8, 6):
    over "data"; decode scores (8, 2, 2, 1, 6): batch over "data", heads
    over "model" — the reference's specs."""
    ranks, _, _ = runs
    e = np.arange(4 * 8 * 6, dtype=np.float32).reshape(4, 8, 6)
    t = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    sc = np.arange(8 * 2 * 2 * 6, dtype=np.float32).reshape(8, 2, 2, 1, 6)
    for r in ranks:
        i, j = (int(c) for c in r["coord"])
        assert list(r["expert_places"]) == ["R", "S(0)"]
        assert np.array_equal(r["expert_local"], e[2 * j:2 * j + 2])
        assert list(r["token_places"]) == ["S(0)", "R"]
        assert np.array_equal(r["token_local"], t[2 * i:2 * i + 2])
        assert list(r["scores_places"]) == ["S(0)", "S(1)"]
        assert np.array_equal(r["scores_local"], sc[2 * i:2 * i + 2, j:j + 1])


def test_distributed_muon_twin(runs):
    """Twin of ``tests/test_distributed_muon.py``: the update of a
    row-sharded (512, 64) leaf orthogonalized by the collective TSQR is
    orthonormal to 1e-3 and within 1e-3 of the one-device QR
    orthogonalizer (the reference's bars)."""
    ranks, _, _ = runs
    for r in ranks:
        delta = r["dmuon_delta"].astype(np.float64)
        assert np.abs(delta.T @ delta - np.eye(64)).max() < 1e-3
        assert np.abs(delta - r["dmuon_ref"]).max() < 1e-3
