"""Check whether gloo carries DTensor's own collectives on CUDA tensors.

    python3 scripts/dtensor_gloo_probe.py [--device cuda|cpu]

Spawns two gloo ranks (a ``file://`` store under ``$TMPDIR``) that share
the one card, builds a (2, 1) ``("data", "model")`` mesh and runs, each
announced before it starts, the redistributions the port's mesh step
needs: ``Shard -> Replicate`` (all-gather), ``Partial -> Shard``
(reduce-scatter), ``Partial -> Replicate`` (all-reduce) and ``Shard(0) ->
Shard(1)`` — first through ``repro_torch.distributed.sharding.
redistribute`` (host-staged on a card mesh whose backend is not NCCL),
then through ``DTensor.redistribute`` itself.  It prints one line a
collective and rank, and exits non-zero when a rank dies (on torch 2.11
the second group ends with SIGSEGV on "cuda"; ROADMAP A22).
"""

import argparse
import datetime
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank, store, device):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.distributed import sharding

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    mesh = init_device_mesh(device, (2, 1), mesh_dim_names=("data", "model"))
    x = torch.arange(16, dtype=torch.float32, device=device).reshape(4, 4)
    rows = DTensor.from_local(x[2 * rank:2 * rank + 2], mesh,
                              [Shard(0), Replicate()], run_check=False)
    part = DTensor.from_local(x, mesh, [Partial(), Replicate()],
                              run_check=False)
    cases = [("all-gather", rows, [Replicate(), Replicate()]),
             ("reduce-scatter", part, [Shard(0), Replicate()]),
             ("all-reduce", part, [Replicate(), Replicate()]),
             ("all-to-all", rows, [Shard(1), Replicate()])]
    for route, fn in (("staged", sharding.redistribute),
                      ("DTensor", lambda d, p: d.redistribute(mesh, p))):
        for name, d, places in cases:
            print(f"rank {rank} {route} {name} ...", flush=True)
            out = fn(d, places).to_local()
            print(f"rank {rank} {route} {name}: ok, local sum "
                  f"{float(out.sum())}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    store = os.path.join(tempfile.mkdtemp(), "store")
    try:
        mp.start_processes(rank_main, args=(store, args.device), nprocs=2,
                           join=True, start_method="spawn")
    except Exception as e:  # a rank died: report it as the result
        print(f"a rank failed: {type(e).__name__}: {e}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
