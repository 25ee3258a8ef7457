"""The inputs both sides get, made from the run's seed by the
benchmark's own code: the weights (one draw on the device, carved into
the leaves of :func:`model.param_spec`), the training batches (a copy of
the synthetic token stream the program's trainer reads), and the
prompts."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import model


def weights(spec, seed: int, device, scales=None) -> dict:
    """The tree of ``spec`` as float32 tensors on ``device``: the normal
    leaves from one ``torch.randn`` of a generator seeded with ``seed``,
    each a view of that draw times its scale (``scales``: leaf name ->
    another scale); the constant leaves filled."""
    scales = scales or {}
    named = model.leaves(spec)
    total = sum(math.prod(i.shape) for _, i in named if i.scale is not None)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, init in named:
        n = math.prod(init.shape)
        if init.scale is not None:
            out[name] = flat[off:off + n].view(init.shape).mul_(scales.get(name, init.scale))
            off += n
        else:
            row = torch.cat([torch.full((c,), float(v), device=device)
                             for c, v in init.segments])
            out[name] = row.expand(init.shape).contiguous()
    return unflatten(spec, out)


def unflatten(spec, named: dict, prefix=""):
    """The tree of ``spec`` with its leaves taken from ``named``."""
    if isinstance(spec, dict):
        return {k: unflatten(v, named, f"{prefix}.{k}" if prefix else k)
                for k, v in spec.items()}
    if isinstance(spec, (tuple, list)):
        return tuple(unflatten(v, named, f"{prefix}.{i}" if prefix else str(i))
                     for i, v in enumerate(spec))
    return named[prefix]


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int) -> dict:
    """Step ``step``'s batch of the synthetic stream keyed by ``seed``:
    x_t = (31 x_{t-1} + x_{t-7} + noise) mod V, tokens and next-token
    labels, int32 numpy arrays."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    x = rng.integers(0, vocab, size=(batch, seq + 8), dtype=np.int64)
    for t in range(8, seq + 8):
        x[:, t] = (x[:, t - 1] * 31 + x[:, t - 7] + rng.integers(0, 4, size=batch)) % vocab
    return {"tokens": x[:, 7:7 + seq].astype(np.int32),
            "labels": x[:, 8:8 + seq].astype(np.int32)}


def prompts(seed: int, batch: int, length: int, vocab: int, device) -> torch.Tensor:
    """(batch, length) int32 token ids, uniform over the vocabulary."""
    gen = torch.Generator(device=device).manual_seed((seed + 1) % 2 ** 64)
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device, dtype=torch.int32)
