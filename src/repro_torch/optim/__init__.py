"""Optimizers of the port: QR-Muon (the paper's MHT QR as orthogonalizer)
and AdamW, as plain functions on name -> tensor dicts.

    adamw          baseline / fallback optimizer
    qr_muon        Muon with MHT-QR or Newton-Schulz orthogonalization
    batched_ortho  shape-class-batched orthogonalization (one planned
                   dispatch per class: on "cuda" the kernels)
    newton_schulz  the NS quintic baseline
    schedule       warmup+cosine LR
"""

from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.batched_ortho import (
    DEFAULT_ORTHO_POLICY, OrthoClassPlan, OrthoPlan, batched_orthogonalize,
    plan_batched_ortho,
)
from repro_torch.optim.newton_schulz import newton_schulz_orthogonalize
from repro_torch.optim.qr_muon import (
    MuonState, is_muon_param, muon_directions, muon_init, muon_update,
    qr_orthogonalize_2d,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWState", "adamw_init", "adamw_update",
    "MuonState", "muon_init", "muon_update", "muon_directions",
    "is_muon_param",
    "qr_orthogonalize_2d", "newton_schulz_orthogonalize", "warmup_cosine",
    "DEFAULT_ORTHO_POLICY", "OrthoClassPlan", "OrthoPlan",
    "batched_orthogonalize", "plan_batched_ortho",
]
