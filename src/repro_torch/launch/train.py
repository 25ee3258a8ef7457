"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 512 --optimizer muon-qr [--smoke] \\
        [--batched-ortho] [--device cpu] [--checkpoint-dir DIR] \\
        [--checkpoint-every N] [--grad-compression] [--mesh d,m]

The reference's flags (``repro.launch.train``), plus ``--device`` ("cuda"
by default; "cpu" to run without a card) and ``--batched-ortho`` (one
QR-Muon orthogonalization dispatch per shape class: on the card, the
kernels).  ``--smoke`` selects the reduced config.  With
``--checkpoint-dir`` the run resumes from the directory's latest
committed checkpoint and saves every ``--checkpoint-every`` steps and at
the end; ``--grad-compression`` runs the int8 error-feedback codec on
the gradients.

``--mesh d,m`` trains on a (data, model) ``DeviceMesh`` of d x m ranks
over the launched process group (the production sharding rules, data
axis "data"): start d x m processes, each with ``RANK``, ``WORLD_SIZE``
and ``MASTER_ADDR``/``MASTER_PORT`` (or ``--init-method``, e.g.
``file:///tmp/store``, with ``--rank`` / ``--world-size``); the backend
is NCCL on "cuda" when there is a card for every rank, else gloo (ranks
sharing a card, or the CPU).  Every rank prints the same losses.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.training import RunConfig, TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--optimizer", default="muon-qr",
                    choices=["muon-qr", "muon-ns", "adamw"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--batched-ortho", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="data,model sizes, e.g. 4,2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--init-method", default="env://")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    args = ap.parse_args(argv)
    mesh = _mesh(args) if args.mesh else None

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed,
                          embedding_input=cfg.embedding_input,
                          d_model=cfg.d_model)
    train_cfg = TrainConfig(optimizer=args.optimizer, lr=args.lr,
                            microbatch=args.microbatch,
                            grad_compression=args.grad_compression,
                            batched_ortho=args.batched_ortho)
    run_cfg = RunConfig(total_steps=args.steps, warmup_steps=args.warmup,
                        checkpoint_dir=args.checkpoint_dir,
                        checkpoint_every=args.checkpoint_every,
                        seed=args.seed)
    trainer = Trainer(cfg, train_cfg, run_cfg, data_cfg, device=args.device,
                      mesh=mesh)
    result = trainer.run()
    print(json.dumps({"final_step": result["final_step"],
                      "last": result["history"][-1] if result["history"]
                      else None}))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _mesh(args):
    """The (data, model) mesh of ``--mesh d,m`` over the launched group
    (initialized here unless the caller did: NCCL when every rank has a
    card of its own, else gloo)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.plan import resolve_device

    d, m = (int(x) for x in args.mesh.split(","))
    dev = resolve_device(args.device).type
    if not dist.is_initialized():
        kw = {}
        if args.rank is not None:
            kw = dict(rank=args.rank, world_size=args.world_size)
        own_card = dev == "cuda" and torch.cuda.device_count() >= d * m
        dist.init_process_group("nccl" if own_card else "gloo",
                                init_method=args.init_method, **kw)
    return init_device_mesh(dev, (d, m), mesh_dim_names=("data", "model"))


if __name__ == "__main__":
    main()
