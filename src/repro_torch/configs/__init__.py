"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

One module per assigned architecture (exact published configs) plus the
paper's own QR workload sizes.  ``ARCHS`` maps the CLI ``--arch`` ids
that the reference's registry also has (the tests hold each against its
twin); ``PORT_ARCHS`` the port's own, which have none.
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
_PORT_MODULES = {
    "jamba2-mini": "jamba2_mini",
}

ARCHS = tuple(_MODULES)
PORT_ARCHS = tuple(_PORT_MODULES)


def _load(arch: str):
    import importlib

    module = _MODULES.get(arch, _PORT_MODULES.get(arch))
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(ARCHS + PORT_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{module}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE


__all__ = ["ARCHS", "PORT_ARCHS", "get_config", "get_smoke_config", "SHAPES",
           "LayerSpec", "ModelConfig", "MoEConfig", "ShapeConfig"]
