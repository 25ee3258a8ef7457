"""Carry the reference's weights into the port.

``params_from_numpy(tree, device)`` takes the reference's
``init_params`` output as numpy arrays (``jax.tree.map(np.asarray,
params)``: nested dicts, with ``layers`` a tuple of period stacks) and
returns the port's :class:`~repro_torch.models.transformer.ParamTree`
holding the same values as fp32 tensors on ``device``, under the same
paths.  The two packages then compute the same model.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import ParamTree

__all__ = ["params_from_numpy"]


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def params_from_numpy(tree, device=None) -> ParamTree:
    """The port's parameters holding the arrays of ``tree`` (fp32), on
    ``device`` ("cuda" unless the caller asks for the CPU)."""
    from repro_torch.core.plan import resolve_device

    return ParamTree(_convert(tree, resolve_device(device)))

