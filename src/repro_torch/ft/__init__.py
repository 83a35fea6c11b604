"""Fault-tolerant training (the JAX package's ``repro.ft``)."""
from .runner import FailureInjector, RunnerConfig, TrainingRunner

__all__ = ["TrainingRunner", "RunnerConfig", "FailureInjector"]
