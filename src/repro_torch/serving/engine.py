"""Serving engine: batched prefill, then cached decode with greedy or
temperature sampling.

Counterpart of the reference's ``repro.serving.engine``:

    engine = ServeEngine(params, cfg, batch=8, max_len=1024)
    out = engine.generate(prompt_tokens, steps=64)

``serve_step`` is one new token against the caches.  The engine prefills
the prompts (one length for the batch), pads the attention caches to
``max_len``, then decodes the batch in lock-step.  Prefill takes a
group of rows at a time, each group at most ``PREFILL_TOKENS`` tokens
(at least one row), and joins the groups' caches: prefill's transients
(a hybrid model's full-sequence Mamba tensors, the experts' activations)
then scale with the group, not the batch.  Every layer but
capacity-dispatch MoE computes a row alone, so the groups' results are
the whole batch's; a config whose MoE drops tokens by capacity couples
the rows and is prefilled whole.  It runs under
``torch.inference_mode()`` on ``device`` ("cuda" unless the caller asks
for the CPU) and raises when the parameters are elsewhere: it never
moves them.  Temperature sampling draws from a ``torch.Generator`` on
that device seeded with ``seed``: reproducible run to run, but not the
reference's JAX random stream.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import resolve_device
from repro_torch.models.transformer import (as_tree, forward_decode,
                                            forward_prefill, named_leaves)
from repro_torch.observability import trace as _trace

Tensor = torch.Tensor

__all__ = ["ServeEngine", "serve_step"]

PREFILL_TOKENS = 16_384


def serve_step(params, tokens: Tensor, cfg: ModelConfig, caches, pos):
    """One decode step: (B, 1) token ids + caches -> (B, 1, V) logits +
    caches (``forward_decode``: the attention caches are written in
    place)."""
    return forward_decode(params, tokens, cfg, caches, pos)


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, batch: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        wrong = {str(t.device) for _, t in named_leaves(params)
                 if t.device.type != self.device.type
                 or (self.device.index is not None
                     and t.device.index != self.device.index)}
        if wrong:
            raise ValueError(f"the parameters are on {sorted(wrong)}, the "
                             f"engine runs on {self.device}; move them first")
        self.params = as_tree(params)
        self.cfg = cfg
        self.batch = batch
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _pad_caches(self, caches):
        """Extend prefill's K/V (axis 2 of the stacked (n_periods, B, S,
        n_kv, D)) with zeros to ``max_len``."""
        out = []
        for entry in caches:
            if "k" in entry:
                pad = self.max_len - entry["k"].shape[2]
                out.append({k: F.pad(entry[k], (0, 0, 0, 0, 0, pad))
                            for k in ("k", "v")})
            else:
                out.append(entry)
        return tuple(out)

    def _sample(self, logits: Tensor) -> Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def prefill(self, prompt_tokens, prompt_embeds=None):
        """The prompts' last-position logits (B, 1, V) and the caches,
        padded to ``max_len`` (the batch a group of rows at a time, but
        whole under capacity dispatch)."""
        with torch.inference_mode():
            if self.cfg.embedding_input and prompt_embeds is not None:
                batch = {"embeds": torch.as_tensor(prompt_embeds,
                                                   device=self.device)}
            else:
                batch = {"tokens": torch.as_tensor(prompt_tokens,
                                                   device=self.device)}
            (key, full), = batch.items()
            b, s = full.shape[:2]
            coupled = self.cfg.moe is not None and self.cfg.moe.capacity_factor is not None
            rows = b if coupled else max(1, PREFILL_TOKENS // s)
            parts = [forward_prefill(self.params, {key: full[r:r + rows]}, self.cfg)
                     for r in range(0, b, rows)]
            if len(parts) == 1:
                logits, caches = parts[0]
            else:
                logits = torch.cat([lg for lg, _ in parts])
                caches = tuple(
                    {k: torch.cat([c[i][k] for _, c in parts], dim=1) for k in entry}
                    for i, entry in enumerate(parts[0][1]))
            del parts
            return logits, self._pad_caches(caches)

    def decode(self, tok: Tensor, caches, pos: int):
        """One decode step (:func:`serve_step`); while tracing a
        ``serve.decode`` span of the host's enqueue, no synchronize."""
        with _trace.span("serve.decode"), torch.inference_mode():
            return serve_step(self.params, tok, self.cfg, caches, pos)

    def sample(self, logits: Tensor) -> Tensor:
        """(B, 1) int32 ids from (B, 1, V) logits (a ``serve.sample``
        span while tracing)."""
        with _trace.span("serve.sample"), torch.inference_mode():
            return self._sample(logits[:, 0])[:, None].to(torch.int32)

    def generate(self, prompt_tokens, steps: int,
                 prompt_embeds: Optional[Tensor] = None) -> Tensor:
        """prompt_tokens: (B, S0) ids.  Returns (B, steps) int32 ids on
        the engine's device."""
        b, s0 = prompt_tokens.shape
        if b != self.batch or s0 + steps > self.max_len:
            raise ValueError(f"prompts {tuple(prompt_tokens.shape)} with "
                             f"{steps} steps do not fit batch {self.batch}, "
                             f"max_len {self.max_len}")
        logits, caches = self.prefill(prompt_tokens, prompt_embeds)
        tok = self.sample(logits)
        out = [tok]
        for i in range(steps - 1):
            logits, caches = self.decode(tok, caches, s0 + i)
            tok = self.sample(logits)
            out.append(tok)
        return torch.cat(out, dim=1)
