"""Serving steps of the LM stack (the JAX package's ``repro.train``; the
training step comes with the training slice)."""
from .serve_step import generate, make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step", "generate"]
