"""Gradient compression: int8 block quantization with error feedback.

Counterpart of the reference's ``repro.distributed.compression``: each
rank quantizes its gradient contribution plus its carried residual to
int8 codes with one fp32 scale per block of 256 elements (symmetric,
round half to even as ``jnp.round``), and carries the new residual in an
error-feedback buffer, so the quantization bias vanishes over steps.

  * :func:`quantize` / :func:`dequantize` — the codec, on any tensor;
  * :func:`ef_compress_tree` — error feedback over a gradient tree (the
    train step's ``grad_compression``);
  * :func:`compressed_psum` — the mean over a process group of every
    rank's decoded contribution, as the reference's ``shard_map``
    collective computes it (it sums the decoded fp32 values).

Plain tensor functions: the reference has no Pallas kernel here.  A
tree is a tensor, or a dict / tuple / list of trees.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import sharding

Tensor = torch.Tensor

__all__ = ["quantize", "dequantize", "ef_compress_tree", "compressed_psum",
           "init_error_state"]

_BLOCK = 256


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _map2(fn, *trees):
    """``fn`` returns a pair per leaf: two trees shaped like the first."""
    first = trees[0]
    if isinstance(first, dict):
        parts = {k: _map2(fn, *(t[k] for t in trees)) for k in first}
        return ({k: v[0] for k, v in parts.items()},
                {k: v[1] for k, v in parts.items()})
    if isinstance(first, (tuple, list)):
        parts = [_map2(fn, *xs) for xs in zip(*trees)]
        return (type(first)(p[0] for p in parts),
                type(first)(p[1] for p in parts))
    return fn(*trees)


def quantize(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Block-wise symmetric int8 quantization: ``(codes, scales)``, codes
    ``(nblocks, 256)`` int8 and one fp32 scale (block max / 127) per
    block; the tail block is zero-padded."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % _BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return codes, scale[:, 0]


def dequantize(codes: Tensor, scales: Tensor, shape) -> Tensor:
    """The fp32 tensor of ``shape`` that ``(codes, scales)`` encode."""
    flat = (codes.to(torch.float32) * scales[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape))


def init_error_state(tree: Any) -> Any:
    """Zero fp32 residuals shaped like ``tree``'s tensors."""
    return _map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


def _encode(g: Tensor, e: Tensor) -> Tuple[Tensor, Tensor]:
    target = g.to(torch.float32) + e
    codes, scales = quantize(target)
    dec = dequantize(codes, scales, target.shape)
    return dec, target - dec


def ef_compress_tree(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Error-feedback compression of a gradient tree: ``(decoded,
    new_error)`` with ``decoded = Q(g + e)`` and ``new_error = (g + e) -
    decoded`` — exactly what a receiver reconstructs."""
    return _map2(_encode, grads, error)


def compressed_psum(tree: Any, group, error: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce over ``group`` (every rank calls
    it): ``(mean, new_error)``, the mean over the ranks of each rank's
    decoded ``Q(g + e)`` and this rank's residual."""
    n = sharding.group_size(group)

    def one(g, e):
        dec, new_e = _encode(g, e)
        return sharding.all_reduce_sum(dec, group) / n, new_e

    return _map2(one, tree, error)
