"""PyTorch + CUDA port of the Householder/MHT QR system (``repro``).

The JAX package ``repro`` is the reference; this package is its port to
PyTorch with hand-written Hopper kernels.  It imports torch, numpy and the
standard library only.  Entry points run on ``"cuda"`` unless the caller
passes ``device="cpu"``.
"""

from repro_torch.core import (QRConfig, QRSolver, geqr2, geqr2_ht, geqrf,
                              lstsq, orthogonalize, plan, qr,
                              qr_algorithm_eig, select_method, tsqr_qr,
                              tsqr_r)

__all__ = ["qr", "orthogonalize", "lstsq", "qr_algorithm_eig", "QRConfig",
           "QRSolver", "plan", "select_method", "geqr2", "geqr2_ht", "geqrf",
           "tsqr_r", "tsqr_qr"]
