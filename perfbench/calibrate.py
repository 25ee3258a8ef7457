"""The readings a cell's limits are set from, on the card at the cell's
own size (not run by the benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--steps N]

Prints one JSON line a seed and reading:
  * ``program``: the program's sound run against the reference (a train
    cell: set-up's followed steps, no window; a decode cell: ``--steps``
    decode steps, as many as a run's window serves);
  * ``control``: the reference computed with float8 products in the
    program's place (the precision below the configuration's bf16);
  * ``half_batch`` (train cells): the reference on the first half of each
    batch in the program's place, the mean taken over those rows;
  * ``witness_bf16`` (train cells): the reference with bf16 products,
    forward and backward: what bf16 arithmetic alone reads.
A step that returns the state unchanged reads 1 on ``change_gap`` and
needs no run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _free(torch):
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def train_seed(cell, seed, control: bool):
    import torch

    from perfbench.reference import compare, inputs, model as ref_model

    train = cell.kind
    t, dev = cell.traffic, cell.device
    ref_cfg = cell.ref_config()
    spec = ref_model.param_spec(ref_cfg)
    out = []
    trainer = train.build(cell, inputs.weights(spec, seed, dev))
    prog = train.follow(cell, trainer, seed)
    del trainer
    _free(torch)
    ref = compare.follow_training(ref_cfg, seed, t, dev, against=prog.pop("grads"),
                                  keep_grads=control)
    out.append(("program", compare.train_readings(prog, ref, ref["diff_norms"])))
    if control:
        for what, kw in (("control", {"precision": "float8"}),
                         ("half_batch", {"rows": t["batch"] // 2}),
                         ("witness_bf16", {"precision": "bfloat16"})):
            _free(torch)
            other = compare.follow_training(ref_cfg, seed, t, dev, against=ref["grads"], **kw)
            out.append((what, compare.train_readings(other, ref, other["diff_norms"])))
    return out


def decode_seed(cell, seed, control: bool, steps: int):
    import numpy as np
    import torch

    from perfbench.reference import compare, inputs, model as ref_model

    t, dev = cell.traffic, cell.device
    ref_cfg = cell.ref_config()
    scales = t.get("weight_scales")
    engine = cell.kind.build(cell, inputs.weights(ref_model.param_spec(ref_cfg), seed, dev,
                                                  scales))
    b, p = t["batch"], t["prompt"]
    prompt = inputs.prompts(seed, b, p, ref_cfg.vocab_size, dev)
    logits, caches = engine.prefill(prompt)
    tok = engine.sample(logits)
    served = [tok]
    for i in range(steps):
        logits, caches = engine.decode(tok, caches, p + i)
        tok = engine.sample(logits)
        served.append(tok)
    rows = np.random.default_rng(seed).choice(b, size=min(t["sample_rows"], b), replace=False)
    tokens = torch.cat([prompt] + served, 1)[torch.as_tensor(np.sort(rows), device=dev)]
    del engine, caches, logits, served
    _free(torch)
    ref = compare.decode_reference(ref_cfg, seed, tokens, p, dev, scales=scales)
    out = [("program", compare.decode_readings(ref, tokens[:, p:]))]
    if control:
        low = compare.decode_reference(ref_cfg, seed, tokens, p, dev, precision="float8",
                                       scales=scales)
        first = low.argmax(-1)
        del low
        out.append(("control", compare.decode_readings(ref, first)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=1000)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import bench

    bench.env_ready()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in seeds:
        cell = bench.Cell(args.workload, seed=seed, seconds=0, trace=False)
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            res = train_seed(cell, seed, control)
        else:
            res = decode_seed(cell, seed, control, args.steps)
        for what, readings in res:
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "readings": readings,
                              "seconds": time.perf_counter() - t0}), flush=True)
        _free(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
