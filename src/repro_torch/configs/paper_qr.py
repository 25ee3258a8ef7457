"""The paper's own QR workload sizes (its figs 11/14 sweep square
matrices on the PE / REDEFINE fabric).

Not one of the 10 assigned LM architectures — this config parameterizes
the QR benchmarks and examples so the paper's experiment grid is
reproducible from one place.
"""

import dataclasses
from typing import Tuple

__all__ = ["PaperQRConfig", "CONFIG"]


@dataclasses.dataclass(frozen=True)
class PaperQRConfig:
    # matrix sizes swept in the paper's performance figures
    sizes: Tuple[Tuple[int, int], ...] = (
        (64, 64), (128, 128), (256, 256), (512, 512), (512, 256),
    )
    block: int = 32                # WY panel width (DGEQRF/DGEQRFHT)
    kernel_panel_max_m: int = 1024  # VMEM budget bound for mht_panel
    tile_grid: Tuple[int, ...] = (1, 2, 4, 8)   # paper's KxK fabric sweep
    dag_sizes: Tuple[int, ...] = (4, 8, 16, 32, 64, 128)  # fig 9 sweep
    rdp_width: int = 4             # DOT4 width for the theta phase model


CONFIG = PaperQRConfig()
