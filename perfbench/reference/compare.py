"""The comparison that decides ``correct``: the reference follows what
the timed path did, and each number compared is held to its limit.

Training: the reference runs the first steps from the same weights and
batches, and four numbers are read, each a relative gap:
  * ``loss_gap``: the widest gap of a step's loss;
  * ``grad_gap``: the worst leaf's gap between the norms of the first
    clipped gradient, against the reference's norm of that leaf or of the
    median leaf, whichever is larger;
  * ``change_gap``: the same of the parameters' change over the followed
    steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off);
  * ``grad_diff``: the worst leaf's norm of the difference of the first
    clipped gradients, against the same denominators.  A norm is blind to
    the unbiased noise of a lower precision (it adds in quadrature), and
    at random initialization the loss is near ln V whatever the
    precision, so the first three numbers cannot tell float8 products
    from bf16 ones; this one can.

Serving: ``mean_gap``, the mean over the served tokens of the gap by
which a served token's logit lies below the reference's best at its
position, and ``logit_gap``, the widest such gap.  The widest gap is an
extreme over thousands of positions: sound bf16 runs reach 2.1 on some
seeds, where the float8 control's widest gaps stop at 5-6, so the mean
is the number held to a limit.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import torch

from . import inputs, model, muon

Tensor = torch.Tensor


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[Sequence[str]] = None) -> tuple:
    """(worst gap, its leaf) of per-leaf norms, each against the larger of
    the reference's norm of the leaf and of the median leaf."""
    med = statistics.median(ref.values())
    names = [k for k in ref if keep is None or k in keep]
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(grad_norms: Dict[str, float]) -> List[str]:
    med = statistics.median(grad_norms.values())
    return [k for k, v in grad_norms.items() if v >= 1e-3 * med]


def train_readings(prog: dict, ref: dict, diff_norms: Dict[str, float]) -> dict:
    """``prog`` / ``ref``: ``losses`` (a list), ``grad_norms`` and
    ``change_norms`` (leaf -> norm); ``diff_norms``: leaf -> the norm of
    the difference of the two first gradients."""
    n = len(ref["losses"])
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"][:n], ref["losses"]))
    grad_gap, grad_leaf = norm_gap(prog["grad_norms"], ref["grad_norms"])
    change_gap, change_leaf = norm_gap(prog["change_norms"], ref["change_norms"],
                                       moved_leaves(ref["grad_norms"]))
    med = statistics.median(ref["grad_norms"].values())
    diffs = {k: v / max(ref["grad_norms"][k], med, 1e-30) for k, v in diff_norms.items()}
    diff_leaf = max(diffs, key=diffs.get)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_diff": diffs[diff_leaf],
            "_leaves": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                        "grad_diff": diff_leaf}}


def leaf_norms(named: Dict[str, Tensor]) -> Dict[str, float]:
    vals = torch.stack([torch.linalg.vector_norm(t.double()) for t in named.values()])
    return dict(zip(named, vals.tolist()))


def host_copy(named: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: t.detach().to("cpu") for k, t in named.items()}


def change_norms(named: Dict[str, Tensor], start: Dict[str, Tensor]) -> Dict[str, float]:
    return leaf_norms({k: named[k].detach() - start[k] for k in named})


def follow_training(cfg, seed: int, traffic: dict, device, *,
                    precision: Optional[str] = None, rows: Optional[int] = None,
                    against: Optional[Dict[str, Tensor]] = None,
                    keep_grads: bool = False) -> dict:
    """The reference's first ``traffic["follow_steps"]`` steps from the
    run's weights and batches: their losses, the first clipped gradient's
    leaf norms and the parameters' change.  ``precision`` names the
    control's rounding; ``rows`` keeps the first rows of each batch.
    With ``against`` (leaf -> another first gradient, anywhere) also the
    norms of the differences (``diff_norms``); ``keep_grads`` keeps the
    first gradient on the host (``grads``)."""
    rnd = model.rounding(precision)
    spec = model.param_spec(cfg)
    tree = inputs.weights(spec, seed, device)
    named = dict(model.leaves(tree))
    for t in named.values():
        t.requires_grad_(True)
    state = muon.init_state({k: t.detach() for k, t in named.items()})
    out = {"losses": []}
    for step in range(traffic["follow_steps"]):
        b = inputs.train_batch(seed, step, traffic["batch"], traffic["seq"], cfg.vocab_size)
        batch = {k: torch.from_numpy(v[:rows]).to(device) for k, v in b.items()}
        loss = model.loss(tree, batch, cfg, rnd)
        grads = torch.autograd.grad(loss, list(named.values()))
        g = muon.clip(dict(zip(named, grads)))
        out["losses"].append(float(loss.detach()))
        if step == 0:
            out["grad_norms"] = leaf_norms(g)
            if against is not None:
                out["diff_norms"] = {k: float(torch.linalg.vector_norm(
                    (g[k] - against[k].to(device)).double())) for k in g}
            if keep_grads:
                out["grads"] = host_copy(g)
        lr = muon.lr_at(step, peak=traffic["lr"], warmup=traffic["warmup_steps"],
                        total=traffic["total_steps"])
        with torch.no_grad():
            muon.update({k: t.detach() for k, t in named.items()}, g, state, lr)
        del loss, grads, g
    del state
    start = dict(model.leaves(inputs.weights(spec, seed, device)))
    out["change_norms"] = change_norms(named, start)
    return out


def served_gaps(ref_logits: Tensor, served: Tensor) -> Tensor:
    """Per position, how far the served token's logit lies below the
    best; ref_logits (B, N, V), served (B, N)."""
    best = ref_logits.amax(-1)
    got = torch.gather(ref_logits, -1, served[..., None].long())[..., 0]
    return best - got


def decode_readings(ref_logits: Tensor, served: Tensor) -> dict:
    gaps = served_gaps(ref_logits, served)
    return {"mean_gap": float(gaps.mean()), "logit_gap": float(gaps.max())}


def decode_reference(cfg, seed: int, tokens: Tensor, served_from: int,
                     device, *, precision: Optional[str] = None, scales=None) -> Tensor:
    """The reference's logits (B, N, V) at the positions that predict
    ``tokens[:, served_from:]``, from one forward pass over ``tokens``
    (the prompts and their served tokens), with the run's weights."""
    params = inputs.weights(model.param_spec(cfg), seed, device, scales)
    with torch.no_grad():
        lg = model.logits(params, tokens[:, :-1].to(device), cfg, model.rounding(precision))
    return lg[:, served_from - 1:]


def check(readings: dict, limits: dict) -> tuple:
    """(all within, [(name, value, limit)]) over the limited readings."""
    rows = [(k, float(readings[k]), float(limits[k])) for k in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
