"""The readings a ``decode_hybrid`` cell's limits are set from, on the
card at the cell's own size (not run by the benchmark's own runs); the
``decode_hybrid`` counterpart of ``perfbench/calibrate.py``.

    python3 perfbench/calibrate_hybrid.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--steps N]

Prints one JSON line a seed and reading: ``program`` (the program's
prefill, warm steps and ``--steps`` decode steps, as many as a run's
window serves, against the reference), and on the control seeds
``control`` (the reference with float8 products in the program's place,
the precision below the configuration's bf16), the witnesses
``witness_bf16`` (the reference with bf16 products) and
``witness_bf16_residual`` (bf16 products and a bf16 residual stream),
and the cache faults ``stale_state`` and ``stale_conv``.  Each line
holds the cell's comparison (``perfbench/reference/compare.check``) of
its readings against the workload file's limits on them: ``correct``
and ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench
    from perfbench.reference import compare

    bench.env_ready()
    import torch

    if not torch.cuda.is_available():
        print("calibrate_hybrid: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in seeds:
        cell = bench.Cell(args.workload, seed=seed, seconds=0, trace=False)
        t0 = time.perf_counter()
        for what, readings in cell.kind.calibrate_seed(cell, seed, control, args.steps):
            ok, checks = compare.check(readings, {k: v for k, v in cell.limits.items()
                                                  if k in readings})
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "readings": readings, "correct": ok, "checks": checks,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
