"""Why olmo-1b smoke's QR-Muon losses part between two correct runs.

    PYTHONPATH=src python scripts/muon_spread_probe.py [--seeds 4]

For each data seed, olmo-1b smoke (fp32, batch 8 x 32, lr 0.02,
``qr_shard_leaves``) trains 6 steps on the CPU three times: as it is,
with every momentum scaled by 1 + 2^-23 before its QR (a one-ulp change,
what another reduction order gives), and with every Q rounded to TF32's
10-bit mantissa (an orthogonalization of TF32 grade).  It prints:

  * the fp64 2-norm condition numbers of the step-2 momenta (min, max
    over the Muon matrices);
  * each perturbed run's largest relative loss difference from the run
    as it is;
  * each perturbed run's first update (step 2) against the run as it
    is, on every column but the last of each matrix in the tall
    orientation the QR factors ("determined") and on the last column
    alone, as the largest relative Frobenius difference over the leaves.

One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig
from repro_torch.optim import is_muon_param, muon_directions, qr_muon
from repro_torch.training import RunConfig, TrainConfig, Trainer, train_step


def _tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _run(cfg, seed: int, mode: str):
    """Losses, the start and step-2 parameters and step 2's momenta."""
    real_orth, real_update = qr_muon._local_orthogonalizer, train_step.muon_update
    recorded = []

    def orth(*a, **k):
        f = real_orth(*a, **k)
        if mode == "ulp":
            return lambda x: f(x * (1 + 2 ** -23))
        if mode == "tf32":
            return lambda x: _tf32(f(x))
        return f

    def update(grads, state, params, **kw):
        recorded.append((grads, state, dict(params), kw["momentum"]))
        return real_update(grads, state, params, **kw)

    qr_muon._local_orthogonalizer, train_step.muon_update = orth, update
    try:
        tr = Trainer(cfg, TrainConfig(optimizer="muon-qr", lr=0.02,
                                      qr_shard_leaves=True),
                     RunConfig(total_steps=6, warmup_steps=1, log_every=1,
                               seed=seed),
                     DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                global_batch=8, seed=seed),
                     device="cpu", log_fn=lambda s: None)
        start = {k: p.detach().clone() for k, p in tr.state.params.named_parameters()}
        tr.run(stop_at=2)
        first = {k: p.detach().clone() for k, p in tr.state.params.named_parameters()}
        tr.run()
    finally:
        qr_muon._local_orthogonalizer, train_step.muon_update = real_orth, real_update
    grads, state, params, momentum = recorded[1]
    _, dirs = muon_directions(grads, state, params, momentum=momentum)
    losses = np.array([m["loss"] for m in tr.metrics_history])
    return losses, start, first, dirs


def _split(update: torch.Tensor):
    d = update.double()
    if d.shape[-2] < d.shape[-1]:
        d = d.mT
    return d[..., :-1], d[..., -1:]


def _rel(x, ref) -> float:
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = get_smoke_config("olmo-1b").scaled(dtype="float32")
    for seed in range(args.seeds):
        base, start, first, dirs = _run(cfg, seed, "base")
        cond = [float((s[..., 0] / s[..., -1]).max()) for s in
                (torch.linalg.svdvals(d.double()) for d in dirs.values())]
        out = {"seed": seed, "cond_min": min(cond), "cond_max": max(cond)}
        muon = [k for k, p in start.items() if is_muon_param(k, p)]
        for mode in ("ulp", "tf32"):
            losses, _, other, _ = _run(cfg, seed, mode)
            out[mode + "_loss_spread"] = float(
                np.max(np.abs(losses - base) / np.abs(base)))
            det, last = [], []
            for k in muon:
                (a, al), (b, bl) = (_split(start[k] - other[k]),
                                    _split(start[k] - first[k]))
                det.append(_rel(a, b))
                last.append(_rel(al, bl))
            out[mode + "_update_determined"] = max(det)
            out[mode + "_update_last_column"] = max(last)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
