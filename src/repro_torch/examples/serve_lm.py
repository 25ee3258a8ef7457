"""Serving example: batched prefill + decode over the gemma2 smoke config.

Twin of the reference's ``examples/serve_lm.py``: random weights drawn
on the device from a generator seeded with 0, four requests of a
32-token prompt, temperature 0.8.

    python -m repro_torch.examples.serve_lm [--device cpu] [--steps 64]
"""

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params
from repro_torch.serving import ServeEngine


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_smoke_config("gemma2-9b")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    engine = ServeEngine(params, cfg, batch=args.batch,
                         max_len=args.prompt_len + args.steps + 8,
                         temperature=0.8, seed=1, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))

    t0 = time.perf_counter()
    out = engine.generate(prompts, steps=args.steps).cpu()
    dt = time.perf_counter() - t0
    print(f"batch={args.batch} x {args.steps} tokens in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s on {dev.type})")
    for i in range(args.batch):
        print(f"request {i}:", out[i, :12].tolist(), "...")
    assert tuple(out.shape) == (args.batch, args.steps)
    assert 0 <= int(out.min()) and int(out.max()) < cfg.vocab_size
    return out


if __name__ == "__main__":
    main()
