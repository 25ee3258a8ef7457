"""Core of the PyTorch port: planner, tile-DAG engine, tiled QR, API."""

from repro_torch.core.api import lstsq, orthogonalize, qr
from repro_torch.core.plan import QRConfig, QRSolver, plan, select_method

__all__ = ["qr", "orthogonalize", "lstsq", "QRConfig", "QRSolver", "plan",
           "select_method"]
