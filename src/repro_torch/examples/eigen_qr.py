"""Paper §1 Application 2: eigenvalues via the QR algorithm (Algorithm 1).

    A_0 = A;  A_k = R_k Q_k  with  Q_k R_k = A_{k-1}

using the MHT-based factorization (``geqrf_ht``).  Validates against
``numpy.linalg.eigvalsh``.  Twin of the reference's ``examples/eigen_qr.py``.

    python -m repro_torch.examples.eigen_qr [--device cpu] [--iters 400]
"""

import argparse

import numpy as np
import torch

from repro_torch import QRConfig, qr_algorithm_eig


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=400)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(1)
    qm, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    lam = np.sort(rng.uniform(0.5, 10.0, 12))[::-1]
    a = torch.tensor(qm @ np.diag(lam) @ qm.T, dtype=torch.float32,
                     device=args.device)

    ev = qr_algorithm_eig(a, iters=args.iters,
                          config=QRConfig(method="geqrf_ht"),
                          device=args.device).cpu().numpy()
    ref = np.sort(np.linalg.eigvalsh(a.cpu().numpy()))[::-1]
    err = float(np.abs(ev - ref).max())
    print("QR-algorithm eigenvalues:", np.round(ev, 3))
    print("numpy eigh             :", np.round(ref, 3))
    print(f"max abs error: {err:.2e}")
    assert err < 5e-2
    return err


if __name__ == "__main__":
    main()
