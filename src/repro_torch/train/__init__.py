"""Training and serving steps of the LM stack (the JAX package's
``repro.train``)."""
from .train_step import (TrainConfig, init_train_state, make_eval_step,
                         make_train_step)
from .serve_step import generate, make_prefill_step, make_serve_step

__all__ = ["TrainConfig", "init_train_state", "make_train_step",
           "make_eval_step", "make_prefill_step", "make_serve_step",
           "generate"]
