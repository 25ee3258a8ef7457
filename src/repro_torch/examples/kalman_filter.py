"""Paper §1 Application 1: numerically stable Kalman filtering via QR.

A square-root Kalman filter tracks a 2-D constant-velocity target; the
covariance propagation takes the R factor of the MHT QR factorization
(``geqrf_ht``, ``mode="r"``).  Twin of the reference's
``examples/kalman_filter.py`` (the same seeded trajectory and updates).

    python -m repro_torch.examples.kalman_filter [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import QRConfig, qr

# R-only blocked-MHT factorization, planned once for the whole filter run.
R_CFG = QRConfig(method="geqrf_ht", mode="r")


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    dt = 0.1
    f = t([[1, 0, dt, 0], [0, 1, 0, dt], [0, 0, 1, 0], [0, 0, 0, 1]])
    h = t([[1, 0, 0, 0], [0, 1, 0, 0]])
    q_sqrt = torch.eye(4, device=dev) * 0.05
    r_sqrt = torch.eye(2, device=dev) * 0.3

    rng = np.random.default_rng(0)
    x_true = t([0.0, 0.0, 1.0, 0.5])
    x_est = torch.zeros(4, device=dev)
    s = torch.eye(4, device=dev)          # sqrt covariance (upper triangular)

    errs = []
    for _ in range(args.steps):
        # truth + measurement
        x_true = f @ x_true + 0.05 * t(rng.standard_normal(4))
        z = h @ x_true + 0.3 * t(rng.standard_normal(2))

        # time update: S' = R factor of [S F^T; Q^T] (QR propagation)
        s = qr(torch.vstack([s @ f.T, q_sqrt]), config=R_CFG,
               device=dev)[:4, :4]
        x_est = f @ x_est

        # measurement update via the QR of the augmented array
        m, n = 2, 4
        aug = torch.vstack([torch.hstack([r_sqrt, torch.zeros((m, n),
                                                             device=dev)]),
                            torch.hstack([s @ h.T, s])])
        r_all = qr(aug, config=R_CFG, device=dev)
        s_zz, k_gain_t, s = r_all[:m, :m], r_all[:m, m:], r_all[m:, m:]
        innov = z - h @ x_est
        x_est = x_est + k_gain_t.T @ torch.linalg.solve(s_zz.T, innov)
        errs.append(float(torch.linalg.vector_norm((x_est - x_true)[:2])))

    first, last = float(np.mean(errs[:10])), float(np.mean(errs[-10:]))
    print(f"square-root KF position RMSE: first10={first:.3f} "
          f"last10={last:.3f}")
    assert last < first
    print("filter converged (QR-based covariance propagation stable)")
    return first, last


if __name__ == "__main__":
    main()
