from .pipeline import DataConfig, SyntheticLM, TSAFilteredLM

__all__ = ["DataConfig", "SyntheticLM", "TSAFilteredLM"]
