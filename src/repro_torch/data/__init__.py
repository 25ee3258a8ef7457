"""Data pipeline substrate (deterministic, shardable, resumable)."""

from repro_torch.data.pipeline import DataConfig, MemmapCorpus, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "MemmapCorpus", "make_pipeline"]
