"""PyTorch + CUDA port of the Householder/MHT QR system (``repro``).

The JAX package ``repro`` is the reference; this package is its port to
PyTorch with hand-written Hopper kernels.  It imports torch, numpy and the
standard library only.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""

from repro_torch.core import (QRConfig, QRSolver, lstsq, orthogonalize, plan,
                              qr, select_method)

__all__ = ["qr", "orthogonalize", "lstsq", "QRConfig", "QRSolver", "plan",
           "select_method"]
