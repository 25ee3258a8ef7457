"""The elastic re-mesh of the port (``repro_torch.distributed.
fault_tolerance.plan_elastic_mesh``, resharded restore through
``Trainer(mesh=...)`` and ``CheckpointManager``) on the CPU.

Twin of ``tests/test_fault_tolerance_e2e.py``'s drill, on gloo ranks
joined through ``file://`` stores under ``tmp_path``, once per module:

  * phase 1: eight ranks train olmo-1b smoke (AdamW, batch 8 x 32) on a
    (4, 2) ``("data", "model")`` mesh, checkpointing every 3 steps, and
    "crash" after step 6; the same ranks then run on to step 10 without
    a break (the uninterrupted run);
  * phase 2: four ranks (ranks 4..7 "failed") plan the largest
    power-of-two mesh over the survivors, (2, 2) at ``prefer_model=2``,
    restore step 6 resharded onto it and train to step 10.

The restored state equals the saved one bit for bit (whole tensors); the
data cursor and step index resume at 6; the resumed losses are within
1e-3 relative of the uninterrupted run's (the reference's restart bar:
the mesh changes the order of the gradient reductions).  Beside it,
``plan_elastic_mesh`` against the reference's on eight forced host
devices, over counts, failures and preferred model sizes.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro_torch.distributed import plan_elastic_mesh
from worker_threads import share_the_cores  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
RESTART_RTOL = 1e-3
# (failed device ids, prefer_model) over eight devices.
PLANS = [([], 16), ([], 2), ([], 1), ([4, 5, 6, 7], 2), ([1], 2),
         ([0, 3, 5], 4), ([1, 2, 3, 4, 5, 6, 7], 1), ([7], 8), ([2, 6], 1)]

_PHASE = textwrap.dedent("""
    import datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    phase, rank, world, store, ckpt, out = (sys.argv[1], int(sys.argv[2]),
                                            int(sys.argv[3]), sys.argv[4],
                                            sys.argv[5], sys.argv[6])
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.manager import _leaves_with_path
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.distributed import sharding
    from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    cfg = get_smoke_config("olmo-1b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    tc = TrainConfig(optimizer="adamw", lr=1e-3)
    rc = RunConfig(total_steps=10, warmup_steps=0, log_every=1,
                   checkpoint_every=3, checkpoint_dir=ckpt)

    def whole_state(tr):
        return {k: (sharding.full_tensor(x.detach()).numpy()
                    if hasattr(x, "device_mesh") else np.asarray(x))
                for k, x in _leaves_with_path(tr.checkpoint_tree())}

    res = {}
    if phase == "1":
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
        t1 = Trainer(cfg, tc, rc, data, device="cpu", mesh=mesh,
                     log_fn=lambda s: None)
        t1.run(stop_at=6)
        saved = whole_state(t1)
        res["steps"] = t1.ckpt.all_steps()
        t1.ckpt = None
        t1.run(resume=False)
        res["losses"] = [m["loss"] for m in t1.metrics_history]
        if rank == 0:
            np.savez(out + ".saved.npz", **saved)
    else:
        plan = plan_elastic_mesh(list(range(8)), failed=[4, 5, 6, 7],
                                 prefer_model=2)
        assert plan.size == world == 4, plan
        t2 = Trainer(cfg, tc, rc, data, device="cpu",
                     mesh=plan.device_mesh("cpu"), log_fn=lambda s: None)
        assert t2.maybe_restore()
        res["restored_step"] = t2.step_idx
        res["restored_cursor"] = t2.pipeline.state_dict()
        restored = whole_state(t2)
        res["local_shapes"] = {k: list(p.to_local().shape)
                               for k, p in t2.state.params.named_parameters()}
        t2.run(resume=False)
        res["final_step"] = t2.step_idx
        res["pipeline_step"] = t2.pipeline.step
        res["losses"] = [m["loss"] for m in t2.metrics_history]
        if rank == 0:
            np.savez(out + ".restored.npz", **restored)
    with open(out, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
""")

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax
    from repro.distributed.fault_tolerance import plan_elastic_mesh
    res = []
    for failed, prefer in json.loads(sys.argv[2]):
        p = plan_elastic_mesh(jax.devices(), failed=failed, prefer_model=prefer)
        res.append(dict(data=p.data_size, model=p.model_size,
                        dropped=p.dropped_devices,
                        ids=[[d.id for d in row] for row in p.mesh.devices]))
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _start(args):
    return subprocess.Popen([sys.executable, "-c"] + args, env=_env(),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """Phase 1 on eight ranks (with the reference's plans beside it),
    then phase 2 on four: ``(phase 1 ranks, phase 2 ranks, saved,
    restored, reference plans)``."""
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    ref_out = str(tmp / "plans.json")
    outs = {1: [str(tmp / f"p1_{r}.json") for r in range(8)],
            2: [str(tmp / f"p2_{r}.json") for r in range(4)]}
    ref = _start([_REFERENCE, ref_out, json.dumps(PLANS)])
    for phase, world in ((1, 8), (2, 4)):
        procs = [_start([_PHASE, str(phase), str(r), str(world),
                         str(tmp / f"store{phase}"), ckpt, outs[phase][r]])
                 for r in range(world)]
        _finish(procs)
    _finish([ref])
    load = lambda fs: [json.load(open(f)) for f in fs]  # noqa: E731
    with open(ref_out) as f:
        plans = json.load(f)
    return (load(outs[1]), load(outs[2]),
            dict(np.load(outs[1][0] + ".saved.npz")),
            dict(np.load(outs[2][0] + ".restored.npz")), plans)


def test_restored_state_is_the_saved_one(drill):
    """The (2, 2) mesh restores step 6 of the (4, 2) mesh's run: every
    leaf of the parameters and optimizer state, whole, bit for bit, the
    data cursor at 6, and each rank holding its (2, 2) shard."""
    one, two, saved, restored, _ = drill
    assert all(r["steps"] == [3, 6] for r in one)
    assert set(saved) == set(restored) and saved
    for k in saved:
        assert saved[k].shape == restored[k].shape, k
        assert np.array_equal(saved[k], restored[k]), k
    for r in two:
        assert r["restored_step"] == 6
        assert r["restored_cursor"]["step"] == 6
    # The embedding table (256, 64): vocab over "model", embed over "data".
    assert two[0]["local_shapes"]["embed.table"] == [128, 32]


def test_elastic_run_reaches_step_10_resharded(drill):
    """Twin of ``test_fault_tolerance_e2e.py::test_elastic_restart_
    subprocess``: the four survivors run steps 7 to 10 (finite losses,
    every rank the same) within 1e-3 relative of the uninterrupted
    eight-rank run's."""
    one, two, _, _, _ = drill
    for r in two:
        assert r["final_step"] == 10 and r["pipeline_step"] == 10
        assert r["losses"] == two[0]["losses"]
    tail = np.array(two[0]["losses"])
    whole = np.array(one[0]["losses"])
    assert len(whole) == 10 and len(tail) == 4
    assert np.isfinite(tail).all()
    np.testing.assert_allclose(tail, whole[6:], rtol=RESTART_RTOL, atol=0)


@pytest.mark.parametrize("case", range(len(PLANS)))
def test_plan_elastic_mesh_matches_reference(drill, case):
    """The port's plan over rank ids 0..7 is the reference's over eight
    devices: mesh sizes, dropped count and the grid of ids."""
    want = drill[4][case]
    failed, prefer = PLANS[case]
    p = plan_elastic_mesh(list(range(8)), failed=failed, prefer_model=prefer)
    assert (p.data_size, p.model_size, p.dropped_devices) == (
        want["data"], want["model"], want["dropped"])
    assert [list(row) for row in p.ranks] == want["ids"]


def test_plan_elastic_mesh_refuses_an_empty_pool():
    with pytest.raises(RuntimeError, match="no devices left"):
        plan_elastic_mesh([0, 1], failed=[0, 1])
