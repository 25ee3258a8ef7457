"""Traffic kind ``decode``: the program's ``ServeEngine`` serving one
batch of greedy sequences in lock-step.

Set-up makes the weights and the prompts from ``--seed``, runs
``ServeEngine.prefill`` and ``warm_steps`` decode steps (every shape the
window uses).  The window runs ``decode`` then ``sample`` continuously,
each step ending in a synchronize (a served token reaches its user every
step), until ``--seconds`` have passed.  Afterwards the engine is freed
and the reference runs one forward pass over the prompts and served
tokens of ``sample_rows`` sequences drawn from the seed; every served
token is held to the reference's logits at its position.

Traffic parameters: ``batch``, ``prompt`` (tokens), ``temperature`` (0:
greedy), ``max_steps`` (the served tokens kept a sequence),
``warm_steps``, ``sample_rows``, ``trace_steps``, ``weight_scales`` (leaf
name -> the scale of its normal draw, in place of the initial one).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import bench, counts
from perfbench.reference import compare, inputs, model as ref_model
from perfbench.trace import Capture


def build(cell, params_tree):
    """The program's engine for the cell, from the given weights."""
    from repro_torch.models import ParamTree
    from repro_torch.serving import ServeEngine

    t = cell.traffic
    return ServeEngine(ParamTree(params_tree), cell.port_config(), batch=t["batch"],
                       max_len=t["prompt"] + t["max_steps"] + 1,
                       temperature=t["temperature"], seed=cell.seed, device=cell.device)


def run(cell) -> dict:
    t, dev = cell.traffic, cell.device
    b, p = t["batch"], t["prompt"]
    ref_cfg = cell.ref_config()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scales = t.get("weight_scales")
    engine = build(cell, inputs.weights(ref_model.param_spec(ref_cfg), cell.seed, dev, scales))
    prompt = inputs.prompts(cell.seed, b, p, ref_cfg.vocab_size, dev)
    served = torch.zeros((b, t["max_steps"]), dtype=torch.int32, device=dev)
    logits, caches = engine.prefill(prompt)
    tok = engine.sample(logits)
    served[:, :1] = tok
    n = 1

    spans = []   # (name, start, end) around the calls into the engine, when tracing

    def one():
        nonlocal tok, caches, n
        a = time.perf_counter()
        logits, caches = engine.decode(tok, caches, p + n - 1)
        b = time.perf_counter()
        tok = engine.sample(logits)
        served[:, n:n + 1] = tok
        n += 1
        c = time.perf_counter()
        sync(dev)
        if cell.trace:
            spans.extend((("ServeEngine.decode", a, b), ("ServeEngine.sample", b, c),
                          ("synchronize", c, time.perf_counter())))

    for _ in range(t["warm_steps"]):
        one()
    sync(dev)
    spans.clear()

    from repro_torch import observability as obs

    if cell.trace:
        obs.trace.clear()
        obs.enable(tracing=True, annotations=False)
    traced = t["trace_steps"] if cell.trace else 0
    steps = []
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start
    end = t0
    with Capture(traced > 0 and dev == "cuda") as cap:
        while len(steps) < traced and n < t["max_steps"]:
            a = time.perf_counter()
            one()
            end = time.perf_counter()
            steps.append((a, end))
    while end - t0 < cell.seconds and n < t["max_steps"]:
        a = time.perf_counter()
        one()
        end = time.perf_counter()
        steps.append((a, end))
    spans += [(s.name, s.t_start, s.t_end) for s in obs.trace.spans()] if cell.trace else []
    obs.disable()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    rows = np.random.default_rng(cell.seed).choice(b, size=min(t["sample_rows"], b),
                                                   replace=False)
    tokens = torch.cat([prompt, served[:, :n]], 1)[torch.as_tensor(np.sort(rows), device=dev)]
    del engine, caches, logits, served
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    ref = compare.decode_reference(ref_cfg, cell.seed, tokens, p, dev, scales=scales)
    readings = compare.decode_readings(ref, tokens[:, p:])
    ok, rows_ = compare.check(readings, cell.limits)
    out = {"correct": ok, "checks": rows_, "attempted": b * len(steps), "failed": 0,
           "readings": readings, "device": bench.device_info(torch, dev, peak)}
    e2e = {"decode_tokens_per_s": b * len(steps) / (end - t0), "setup_s": setup_s}
    out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                      for m in cell.end_to_end()}
    if cell.trace:
        tr = cap.trace
        out["ctx"] = {"kind": "decode", "steps": steps, "spans": spans, "trace": tr,
                      "traced_steps": min(traced, len(steps)), "profiled": steps[:traced],
                      "flops": counts.decode_flops(ref_cfg, b, p + n),
                      "bytes": counts.decode_bytes(ref_cfg, b)}
        if tr is not None:
            out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps(spans)}
    return out


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()
