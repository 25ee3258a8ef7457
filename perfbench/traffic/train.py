"""Traffic kind ``train``: the program's ``Trainer`` run step by step.

Set-up builds one trainer from the benchmark's weights (``--seed``) and
drives it through its first ``follow_steps`` steps, which also build and
warm every kernel and shape; it records each step's loss, the first
clipped gradient's leaf norms (from the optimizer's state after one
step) and the parameters' change after the last.  The same trainer then
runs the window: whole steps, each the data pipeline, forward and
backward, clipping and the QR-Muon update, until the next would end past
``--seconds``.  Afterwards the trainer is freed and the reference follows
the same steps from the same weights and batches.

Traffic parameters: ``batch``, ``seq``, ``optimizer``, ``batched_ortho``,
``lr``, ``warmup_steps``, ``total_steps`` (the schedule's), ``follow_steps``,
``trace_steps`` (steps of the window under the profiler).
"""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import torch

from perfbench import bench, counts
from perfbench.reference import compare, inputs, model as ref_model, muon as ref_muon
from perfbench.trace import Capture


def build(cell, params_tree):
    """The program's trainer for the cell, from the given weights."""
    from repro_torch.data import DataConfig
    from repro_torch.models import ParamTree
    from repro_torch.training import RunConfig, TrainConfig, Trainer

    t, cfg = cell.traffic, cell.port_config()
    return Trainer(
        cfg, TrainConfig(optimizer=t["optimizer"], batched_ortho=t["batched_ortho"], lr=t["lr"]),
        RunConfig(total_steps=t["total_steps"], warmup_steps=t["warmup_steps"],
                  log_every=1, checkpoint_every=t["total_steps"], seed=cell.seed),
        DataConfig(vocab_size=cfg.vocab_size, seq_len=t["seq"], global_batch=t["batch"],
                   seed=cell.seed),
        device=cell.device, log_fn=lambda _msg: None, params=ParamTree(params_tree))


def step(trainer) -> dict:
    """One whole step through ``Trainer.run``; its logged metrics."""
    trainer.run(resume=False, stop_at=trainer.step_idx + 1)
    return trainer.metrics_history[-1]


def first_grads(trainer) -> dict:
    """Each leaf's clipped first gradient, from the optimizer's state
    after one step: QR-Muon's momentum is the gradient, AdamW's first
    moment (1 - b1) times it."""
    opt = trainer.state.opt
    named = {}
    for k, p in trainer.state.params.named_parameters():
        mu = opt.mu[k]
        named[k] = mu if ref_muon.is_muon(k, p.shape) else mu / (1 - ref_muon.B1)
    return named


def follow(cell, trainer, seed):
    """The program's readings over its first ``follow_steps`` steps: the
    losses, the first gradient (its leaf norms, and the gradient itself
    on the host) and the parameters' change."""
    spec = ref_model.param_spec(cell.ref_config())
    prog = {"losses": [], "step_s": []}
    for i in range(cell.traffic["follow_steps"]):
        t0 = time.perf_counter()
        prog["losses"].append(step(trainer)["loss"])
        prog["step_s"].append(time.perf_counter() - t0)
        if i == 0:
            g = first_grads(trainer)
            prog["grad_norms"] = compare.leaf_norms(g)
            prog["grads"] = compare.host_copy(g)
            del g
    start = dict(ref_model.leaves(inputs.weights(spec, seed, cell.device)))
    prog["change_norms"] = compare.change_norms(
        dict(trainer.state.params.named_parameters()), start)
    return prog


def run(cell) -> dict:
    t, dev = cell.traffic, cell.device
    ref_cfg = cell.ref_config()
    spec = ref_model.param_spec(ref_cfg)
    if dev == "cuda":
        from repro_torch.kernels import _build

        _build.library()
        torch.cuda.reset_peak_memory_stats()
    trainer = build(cell, inputs.weights(spec, cell.seed, dev))
    prog = follow(cell, trainer, cell.seed)
    sync(dev)

    from repro_torch import observability as obs

    if cell.trace:
        obs.trace.clear()
        obs.enable(tracing=True, annotations=False)
    tokens = t["batch"] * t["seq"]
    traced = t["trace_steps"] if cell.trace else 0
    steps, losses = [], []
    t0 = time.perf_counter()
    setup_s = t0 - cell.t_start

    # A profiled step takes about twice as long; before the window has a
    # step of its own, expect one as long as set-up's steps after the first.
    typical = statistics.mean(prog.pop("step_s")[1:] or [0.0])

    def one():
        a = time.perf_counter()
        losses.append(step(trainer)["loss"])
        steps.append((a, time.perf_counter()))

    def room() -> bool:
        """Whether the next step, as long as the mean so far, and then the
        profiled steps end inside the window."""
        mean = statistics.mean(b - a for a, b in steps) if steps else typical
        return time.perf_counter() - t0 + mean * (1 + 2 * traced) <= cell.seconds

    while (not steps and not traced) or room():
        one()
    with Capture(traced > 0 and dev == "cuda") as cap:
        for _ in range(traced):
            one()
    attempted, failed = len(steps), sum(not math.isfinite(x) for x in losses)
    print("perfbench: window steps (s)", [round(b - a, 3) for a, b in steps], file=sys.stderr)
    spans = [(s.name, s.t_start, s.t_end) for s in obs.trace.spans()] if cell.trace else []
    obs.disable()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    del trainer
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()

    ref = compare.follow_training(ref_cfg, cell.seed, t, dev, against=prog.pop("grads"))
    readings = compare.train_readings(prog, ref, ref["diff_norms"])
    ok, rows = compare.check(readings, cell.limits)
    out = {"correct": ok and failed == 0, "checks": rows, "attempted": attempted,
           "failed": failed, "readings": readings, "device": bench.device_info(torch, dev, peak),
           "metrics": {}}
    window = steps[-1][1] - t0
    e2e = {"train_tokens_per_s": tokens * len(steps) / window, "setup_s": setup_s}
    out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                      for m in cell.end_to_end()}
    if cell.trace:
        tr = cap.trace
        out["ctx"] = {"kind": "train", "steps": steps, "spans": spans, "trace": tr,
                      "traced_steps": traced, "profiled": steps[len(steps) - traced:],
                      "qr": counts.qr_step(ref_cfg),
                      "model_flops": counts.train_flops(ref_cfg, t["batch"], t["seq"])}
        if tr is not None:
            out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps(spans)}
    return out


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()
