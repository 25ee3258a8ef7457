"""Serving launcher: batched generation over a (smoke or full) arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --batch 4 --prompt-len 32 --steps 64 [--temperature 0.8] \\
        [--device cpu]

The reference's flags (``repro.launch.serve``) and JSON line, plus
``--device`` ("cuda" by default; "cpu" to run without a card).  Weights
and prompts are drawn on the device from ``torch.Generator``s seeded
with ``--seed`` (and ``--seed`` + 1 for the prompts).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core.plan import resolve_device
from repro_torch.models import init_params
from repro_torch.models.layers import embed
from repro_torch.serving import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed),
                         cfg)
    engine = ServeEngine(params, cfg, batch=args.batch,
                         max_len=args.prompt_len + args.steps + 8,
                         temperature=args.temperature, seed=args.seed,
                         device=dev)
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1))
    embeds = None
    if cfg.embedding_input:
        with torch.no_grad():
            embeds = embed(params.tree()["embed"], prompts,
                           dtype=torch.bfloat16)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.steps, prompt_embeds=embeds).cpu()
    dt = time.perf_counter() - t0
    row = {
        "arch": cfg.name, "batch": args.batch, "steps": args.steps,
        "wall_s": round(dt, 3),
        "tokens_per_s": round(args.batch * args.steps / dt, 1),
        "sample": out[0, :16].tolist(),
    }
    print(json.dumps(row))
    return row


if __name__ == "__main__":
    main()
