"""The port's benchmark: one cell, one run, one result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with an NVIDIA card; puts
the checkout's ``src`` on ``sys.path``.  Exits non-zero, printing no
result, without a card, without the program, or when JAX or the JAX
package was loaded.  With ``--trace 0`` the result's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench

    bench.env_ready()
    import torch

    cell = bench.Cell(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), t_start=T_START)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    out = bench.run(cell)
    loaded = bench.forbidden_loaded()
    if loaded:
        print(f"perfbench: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"readings {out['readings']}", file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(bench.result_line(cell, out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
