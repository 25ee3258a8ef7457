"""Core of the PyTorch port: planner, tile-DAG engine, tiled QR, the
classical/MHT/blocked/TSQR factorizations, API, and ``dag``, the paper's
beta/theta parallelism metric over the HT, MHT and tiled DAGs."""

from repro_torch.core.api import lstsq, orthogonalize, qr, qr_algorithm_eig
from repro_torch.core.blocked import geqrf, geqrf_fori, larft
from repro_torch.core.householder import (apply_q, form_q, geqr2, house_vector,
                                          unpack_r, unpack_v)
from repro_torch.core.mht import geqr2_ht, mht_update
from repro_torch.core.plan import (MethodSpec, QRConfig, QRSolver,
                                   available_methods, get_method, plan,
                                   register_method, select_method)
from repro_torch.core.engine import schedule_stats
from repro_torch.core.tilegraph import (sharded_wavefront_count, tiled_qr,
                                        wavefront_count, wavefronts)
from repro_torch.core import dag
from repro_torch.core.tsqr import tsqr_qr, tsqr_r

__all__ = ["qr", "orthogonalize", "lstsq", "qr_algorithm_eig", "QRConfig",
           "QRSolver", "plan", "select_method", "geqr2", "geqr2_ht", "geqrf",
           "geqrf_fori", "larft", "house_vector", "apply_q", "form_q",
           "unpack_r", "unpack_v", "mht_update", "tsqr_r", "tsqr_qr",
           "MethodSpec", "available_methods", "get_method", "register_method",
           "schedule_stats", "tiled_qr", "wavefronts", "wavefront_count",
           "sharded_wavefront_count", "dag"]
