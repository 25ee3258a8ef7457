"""Traffic kind ``decode_hybrid``: the program's ``ServeEngine`` serving
one batch of greedy sequences in lock-step on a hybrid model, whose
caches hold attention K/V beside recurrent states (Jamba:
``perfbench/reference/jamba.py``, ``perfbench/counts/jamba.py``).

The window is the ``decode`` kind's: set-up makes the weights and the
prompts from ``--seed``, runs ``ServeEngine.prefill`` and ``warm_steps``
decode steps (every shape the window uses); the window runs ``decode``
then ``sample`` continuously, each step ending in a synchronize, until
``--seconds`` have passed.  Set-up also holds the program's logits of
the prefill and of the warm steps for ``sample_rows`` sequences drawn
from the seed.  Afterwards the engine is freed and the reference runs
one forward pass over those sequences' prompts and served tokens:

  * ``logit_gap``: the relative gap of the held logits as a whole,
    ||program - reference|| / ||reference|| over every held position and
    the vocabulary (prefill and then cached decode against the full
    forward pass); ``logit_gap_max`` the widest such gap of one
    position, not compared: a position whose top-2 experts nearly tie
    somewhere in the stack flips expert under bf16 rounding and reads
    several times the rest;
  * ``mean_gap``: the mean over every served token of the gap by which
    its reference logit lies below the reference's best at its position
    (``served_gap_max`` the widest, not compared).

``ctx`` carries the ``decode`` kind's keys, so its readers work
unchanged, and ``moe_roofline_s`` (a step's MoE work at its roofline)
and ``moe_pairs`` (the program's count of routed (token, choice) pairs
a window step, from its host counter ``models.moe_pairs``).

Traffic parameters: ``batch``, ``prompt`` (tokens), ``temperature`` (0:
greedy), ``max_steps`` (the served tokens kept a sequence),
``warm_steps``, ``sample_rows``, ``trace_steps``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import bench
from perfbench.counts import jamba as counts
from perfbench.reference import compare, inputs, jamba as ref_model, model as ref_base
from perfbench.trace import Capture


def build(cell, cfg, params_tree):
    """The program's engine for the cell, from the given weights."""
    from repro_torch.models import ParamTree
    from repro_torch.serving import ServeEngine

    t = cell.traffic
    return ServeEngine(ParamTree(params_tree), cfg, batch=t["batch"],
                       max_len=t["prompt"] + t["max_steps"] + 1,
                       temperature=t["temperature"], seed=cell.seed, device=cell.device)


class Session:
    """One batch served: the prefill, then one ``step`` a token; the
    logits of ``rows`` kept where a step is asked to hold them."""

    def __init__(self, engine, prompt, max_steps: int, rows):
        self.engine, self.p, self.rows = engine, prompt.shape[1], rows
        logits, self.caches = engine.prefill(prompt)
        self.held = [logits[rows, 0].float()]
        self.tok = engine.sample(logits)
        self.served = torch.zeros((prompt.shape[0], max_steps), dtype=torch.int32,
                                  device=prompt.device)
        self.served[:, :1] = self.tok
        self.n = 1

    def step(self, hold: bool = False):
        """One decode step; its host times (start, decode done, sample
        done)."""
        a = time.perf_counter()
        logits, self.caches = self.engine.decode(self.tok, self.caches, self.p + self.n - 1)
        b = time.perf_counter()
        if hold:
            self.held.append(logits[self.rows, 0].float())
        self.tok = self.engine.sample(logits)
        self.served[:, self.n:self.n + 1] = self.tok
        self.n += 1
        return a, b, time.perf_counter()


def sample_rows(seed: int, batch: int, rows: int, device):
    pick = np.random.default_rng(seed).choice(batch, size=min(rows, batch), replace=False)
    return torch.as_tensor(np.sort(pick), device=device)


def moe_pairs() -> float:
    """The program's count of routed (token, choice) pairs so far (0.0
    where it keeps none)."""
    from repro_torch.observability import metrics

    return metrics.REGISTRY.counter_total("models.moe_pairs")


def reference_hidden(cfg, seed: int, tokens, p: int, device, precision=None,
                     residual=None):
    """The reference's final hidden states (R, N, d) at the positions that
    predict ``tokens[:, p:]``, one forward pass over ``tokens`` with the
    run's weights, and the head's weight; ``precision`` rounds the
    products' operands, ``residual`` the residual stream."""
    params = inputs.weights(ref_model.param_spec(cfg), seed, device)
    with torch.no_grad():
        x = ref_model.hidden(params, tokens[:, :-1], cfg, ref_base.rounding(precision),
                             ref_base.rounding(residual))
    # a copy: the leaf is a view of the one draw, which it would keep alive
    return x[:, p - 1:], ref_model.head_weight(params, cfg).clone()


def readings(x, w, served, held, chunk: int = 256) -> dict:
    """``served`` (R, N) ids and ``held`` (R, H, V) logits against the
    reference's hidden states ``x`` (R, N, d) and head ``w``."""
    with torch.no_grad():
        gaps = torch.cat([compare.served_gaps(x[:, c:c + chunk] @ w, served[:, c:c + chunk])
                          for c in range(0, x.shape[1], chunk)], 1)
        ref = x[:, :held.shape[1]] @ w
        rel = torch.linalg.vector_norm(held - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
        whole = torch.linalg.vector_norm(held - ref) / torch.linalg.vector_norm(ref)
    return {"mean_gap": float(gaps.mean()), "logit_gap": float(whole),
            "logit_gap_max": float(rel.max()), "served_gap_max": float(gaps.max())}


def imitate(x, w, held_len: int, precision: str, chunk: int = 256):
    """What a lower-precision reference (hidden ``x``, head ``w``) serves
    in the program's place: its greedy tokens and its first logits."""
    rnd = ref_base.rounding(precision)
    with torch.no_grad():
        served = torch.cat([(rnd(x[:, c:c + chunk]) @ rnd(w)).argmax(-1)
                            for c in range(0, x.shape[1], chunk)], 1)
        return served, rnd(x[:, :held_len]) @ rnd(w)


def _free(dev):
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()


def run(cell) -> dict:
    t, dev = cell.traffic, cell.device
    cfg = cell.port_config()     # a program without this configuration fails here, at once
    ref_cfg = cell.ref_config()
    b, p = t["batch"], t["prompt"]
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    engine = build(cell, cfg, inputs.weights(ref_model.param_spec(ref_cfg), cell.seed, dev))
    prompt = inputs.prompts(cell.seed, b, p, ref_cfg.vocab_size, dev)
    rows = sample_rows(cell.seed, b, t["sample_rows"], dev)
    ses = Session(engine, prompt, t["max_steps"], rows)

    spans = []   # (name, start, end) around the calls into the engine, when tracing

    def one(hold=False):
        a, b_, c = ses.step(hold)
        sync(dev)
        if cell.trace:
            spans.extend((("ServeEngine.decode", a, b_), ("ServeEngine.sample", b_, c),
                          ("synchronize", c, time.perf_counter())))

    for _ in range(t["warm_steps"]):
        one(hold=True)
    sync(dev)
    spans.clear()

    from repro_torch import observability as obs

    if cell.trace:
        obs.trace.clear()
        obs.enable(tracing=True, annotations=False)
    traced = t["trace_steps"] if cell.trace else 0
    steps = []
    pairs0 = moe_pairs()
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    end = t0
    with Capture(traced > 0 and dev == "cuda") as cap:
        while len(steps) < traced and ses.n < t["max_steps"]:
            a = time.perf_counter()
            one()
            end = time.perf_counter()
            steps.append((a, end))
    while end - t0 < cell.seconds and ses.n < t["max_steps"]:
        a = time.perf_counter()
        one()
        end = time.perf_counter()
        steps.append((a, end))
    pairs = (moe_pairs() - pairs0) / max(len(steps), 1)
    spans += [(s.name, s.t_start, s.t_end) for s in obs.trace.spans()] if cell.trace else []
    obs.disable()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    n = ses.n
    tokens = torch.cat([prompt[rows], ses.served[rows, :n]], 1)
    held = torch.stack(ses.held, 1)
    del engine, ses
    _free(dev)

    x, w = reference_hidden(ref_cfg, cell.seed, tokens, p, dev)
    res = readings(x, w, tokens[:, p:], held)
    ok, rows_ = compare.check(res, cell.limits)
    out = {"correct": ok, "checks": rows_, "attempted": b * len(steps), "failed": 0,
           "readings": res, "device": bench.device_info(torch, dev, peak)}
    e2e = {"decode_tokens_per_s": b * len(steps) / (end - t0), "setup_s": setup_s}
    out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                      for m in cell.end_to_end()}
    if cell.trace:
        tr = cap.trace
        # the mean context of the steps mfu.decode times (those after the
        # profiled ones): step j of the window attends to p + warm + 1 + j
        # positions, the last to p + n - 1
        first = p + t["warm_steps"] + 1 + min(traced, len(steps) - 1)
        context = (first + p + n - 1) / 2
        out["ctx"] = {"kind": "decode", "steps": steps, "spans": spans, "trace": tr,
                      "traced_steps": min(traced, len(steps)), "profiled": steps[:traced],
                      "flops": counts.decode_flops(ref_cfg, b, context),
                      "bytes": counts.decode_bytes(ref_cfg, b, context),
                      "moe_roofline_s": counts.moe_step(ref_cfg, b)["roofline_s"],
                      "moe_pairs": pairs}
        if tr is not None:
            out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps(spans)}
    return out


def _faults(cell, cfg, spec, seed, prompt, rows, served):
    """[(what, held logits)]: the program decoding ``served`` again from
    prefill's caches with the recurrent states zeroed, the scan and conv
    states both (``stale_state``) and the conv windows alone
    (``stale_conv``)."""
    t, dev = cell.traffic, cell.device
    out = []
    for what, keys in (("stale_state", ("ssm", "conv")), ("stale_conv", ("conv",))):
        _free(dev)
        ses = Session(build(cell, cfg, inputs.weights(spec, seed, dev)), prompt,
                      t["warm_steps"] + 1, rows)
        ses.caches = tuple({k: torch.zeros_like(v) if k in keys else v
                            for k, v in entry.items()} for entry in ses.caches)
        for i in range(t["warm_steps"]):
            ses.tok = served[:, i:i + 1]
            ses.step(hold=True)
        out.append((what, torch.stack(ses.held, 1)))
        del ses
    return out


def calibrate_seed(cell, seed: int, control: bool, steps: int) -> list:
    """[(what, readings)]: the program's run of ``steps`` decode steps
    after the prefill and warm steps, against the reference.  With
    ``control`` also the reference in the program's place, computed with
    float8 products (``control``), with bf16 products (``witness_bf16``:
    what bf16 arithmetic alone reads) and with bf16 products and its
    residual stream rounded to bf16 after each add, as the program keeps
    it (``witness_bf16_residual``); and the cache faults of
    :func:`_faults` (``logit_gap`` and ``logit_gap_max`` only: they decode
    the program's tokens, they serve none)."""
    t, dev = cell.traffic, cell.device
    cfg, ref_cfg = cell.port_config(), cell.ref_config()
    b, p, warm = t["batch"], t["prompt"], t["warm_steps"]
    spec = ref_model.param_spec(ref_cfg)
    prompt = inputs.prompts(seed, b, p, ref_cfg.vocab_size, dev)
    rows = sample_rows(seed, b, t["sample_rows"], dev)
    ses = Session(build(cell, cfg, inputs.weights(spec, seed, dev)), prompt,
                  steps + warm + 1, rows)
    for i in range(warm + steps):
        ses.step(hold=i < warm)
    tokens = torch.cat([prompt[rows], ses.served[rows, :ses.n]], 1)
    held = torch.stack(ses.held, 1)
    served = ses.served[:, :warm + 1]
    del ses
    faults = _faults(cell, cfg, spec, seed, prompt, rows, served) if control else []
    _free(dev)
    x, w = reference_hidden(ref_cfg, seed, tokens, p, dev)
    out = [("program", readings(x, w, tokens[:, p:], held))]
    if control:
        for what, precision, residual in (("control", "float8", None),
                                          ("witness_bf16", "bfloat16", None),
                                          ("witness_bf16_residual", "bfloat16", "bfloat16")):
            _free(dev)
            xl, _ = reference_hidden(ref_cfg, seed, tokens, p, dev, precision, residual)
            served_l, first = imitate(xl, w, held.shape[1], precision)
            del xl
            out.append((what, readings(x, w, served_l, first)))
        for what, stale in faults:
            r = readings(x, w, tokens[:, p:], stale)
            out.append((what, {k: r[k] for k in ("logit_gap", "logit_gap_max")}))
    return out


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()
