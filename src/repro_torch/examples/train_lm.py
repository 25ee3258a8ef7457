"""End-to-end driver: train the ~135M smollm config with the QR-Muon
optimizer (the paper's technique in production position).

    python -m repro_torch.examples.train_lm [--steps 300] [--smoke]
        [--device cpu] [--batched-ortho]

Twin of the reference's ``examples/train_lm.py``: seq 256 / batch 8 with
the full 135M architecture (30 layers, d = 576) by default; ``--smoke``
takes the reduced config.  ``--device`` is "cuda" unless asked.

Fault-tolerance drill (``--fault-tolerance``): the step watchdog
(straggler detection at ``--watchdog-threshold`` x the median step time)
and checkpoint-restore wired into the loop, with two chaos knobs:

    --inject-straggler-at N   sleep one step so the watchdog must flag it
    --crash-at N              stop at step N, rebuild the trainer from
                              scratch, and resume from the last committed
                              checkpoint

It prints the sentinels ``CRASH_SIMULATED step=N``, ``[trainer]
restored step N``, ``[watchdog] straggler step N``, ``STRAGGLERS=[...]``
and ``FT_OK``.  Checkpoints go to ``--checkpoint-dir`` (default: a
directory under the system temporary directory, ``$TMPDIR``).
"""

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.distributed import StepWatchdog
from repro_torch.training import RunConfig, TrainConfig, Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config instead of the full 135M")
    ap.add_argument("--optimizer", default="muon-qr",
                    choices=["muon-qr", "muon-ns", "adamw"])
    ap.add_argument("--batched-ortho", action="store_true",
                    help="one QR dispatch per shape class of the Muon "
                         "matrices (on the card: the kernels)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--fault-tolerance", action="store_true",
                    help="straggler watchdog + crash/restore drill")
    ap.add_argument("--watchdog-threshold", type=float, default=2.5,
                    help="flag steps slower than THRESHOLD x the median")
    ap.add_argument("--inject-straggler-at", type=int, default=None,
                    help="chaos: sleep through step N (needs "
                         "--fault-tolerance)")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="chaos: stop at step N and restart from the last "
                         "committed checkpoint (needs --fault-tolerance)")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)("smollm-135m")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)

    def build_trainer():
        watchdog = None
        if args.fault_tolerance:
            watchdog = StepWatchdog(
                threshold=args.watchdog_threshold,
                on_straggler=lambda s, dt, med: print(
                    f"[watchdog] straggler step {s}: {dt:.2f}s "
                    f"vs median {med:.2f}s", flush=True))
        trainer = Trainer(
            cfg,
            TrainConfig(optimizer=args.optimizer, lr=0.02, microbatch=4,
                        batched_ortho=args.batched_ortho),
            RunConfig(total_steps=args.steps, warmup_steps=20,
                      log_every=10, checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.checkpoint_dir),
            data, device=args.device, watchdog=watchdog,
            log_fn=lambda s: print(s, flush=True))
        if args.inject_straggler_at is not None:
            # The delay scales off the live median, so the straggler rule
            # fires however fast this host steps.
            real_step = trainer._step

            def slow_step(state, batch, lr, _real=real_step):
                if trainer.step_idx == args.inject_straggler_at:
                    wd = trainer.watchdog
                    time.sleep(max(0.5, 2.0 * wd.threshold * wd.median))
                return _real(state, batch, lr)

            trainer._step = slow_step
        return trainer

    trainer = build_trainer()
    if args.fault_tolerance and args.crash_at is not None:
        partial = trainer.run(stop_at=args.crash_at)
        print(f"CRASH_SIMULATED step={partial['final_step']}", flush=True)
        # A real crash loses the process: rebuilding the trainer from
        # scratch and resuming is the restart path.
        trainer = build_trainer()
    result = trainer.run()
    hist = result["history"]
    print(f"\nfirst logged loss {hist[0]['loss']:.3f} -> "
          f"final {hist[-1]['loss']:.3f} over {result['final_step']} steps")
    if args.fault_tolerance:
        print(f"STRAGGLERS={trainer.watchdog.straggler_steps}")
        print("FT_OK")
    return result


if __name__ == "__main__":
    main()
