"""Time ``repro_torch.qr`` on the card at the tiled cells, for one tree.

    python3 scripts/qr_ms.py [--src DIR] [--label NAME]

imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``)
and prints one JSON line: the label, the card's name and power limit, and
the host-clock ms of ``qr`` (around the call and a synchronize; median of
5 after one warm-up, 3 for the stack, as ``chip_smoke.py`` times them) at
2048², 640² and the (60, 576, 576) stack, fp32, seeded Gaussian inputs.

Comparing two trees: run it alternately from their ``src`` directories,
each run a fresh process, all on the same card one after another, e.g.

    for i in 0 1 2 3 4 5 6 7 8 9; do
      python3 scripts/qr_ms.py --src parent/src --label parent
      python3 scripts/qr_ms.py --src src --label change
    done

(alternating which side runs first).  The kernels build on a tree's first
run into its own ``build/``.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CELLS = (("2048", (2048, 2048), 5), ("640", (640, 640), 5),
         ("stack", (60, 576, 576), 3))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    out = dict(label=args.label, src=args.src, card=card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, reps in CELLS:
        a = torch.randn(shape, generator=gen, device="cuda")
        repro_torch.qr(a)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            repro_torch.qr(a)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"qr_ms_{name}"] = statistics.median(times)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
