"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --batch 8 --seq 512 --optimizer muon-qr [--smoke] \\
        [--batched-ortho] [--device cpu] [--checkpoint-dir DIR] \\
        [--checkpoint-every N] [--grad-compression]

The reference's flags (``repro.launch.train``), plus ``--device`` ("cuda"
by default; "cpu" to run without a card) and ``--batched-ortho`` (one
QR-Muon orthogonalization dispatch per shape class: on the card, the
kernels).  ``--smoke`` selects the reduced config.  With
``--checkpoint-dir`` the run resumes from the directory's latest
committed checkpoint and saves every ``--checkpoint-every`` steps and at
the end; ``--grad-compression`` runs the int8 error-feedback codec on
the gradients.  ``--mesh`` waits for mesh training (ROADMAP A21) and
raises.
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
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh needs mesh training (ROADMAP A21)")

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
    trainer = Trainer(cfg, train_cfg, run_cfg, data_cfg, device=args.device)
    result = trainer.run()
    print(json.dumps({"final_step": result["final_step"],
                      "last": result["history"][-1] if result["history"]
                      else None}))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
