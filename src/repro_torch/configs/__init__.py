"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

One module per assigned architecture (exact published configs) plus the
paper's own QR workload sizes.  ``ARCHS`` maps the CLI ``--arch`` ids.
"""

from repro_torch.configs.base import SHAPES, LayerSpec, ModelConfig, MoEConfig, ShapeConfig

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "olmo-1b": "olmo_1b",
    "qwen2.5-32b": "qwen2_5_32b",
    "smollm-135m": "smollm_135m",
    "gemma2-9b": "gemma2_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "chameleon-34b": "chameleon_34b",
    "musicgen-large": "musicgen_large",
}

ARCHS = tuple(_MODULES)


def _load(arch: str):
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE


__all__ = ["ARCHS", "get_config", "get_smoke_config", "SHAPES",
           "LayerSpec", "ModelConfig", "MoEConfig", "ShapeConfig"]
