"""The LM stack's models in PyTorch (the JAX package's ``repro.models``):
layers, GQA attention, MoE, Mamba2 SSD and the model zoo — a forward that
is differentiable (with rematerialisation) for training, and serving
(prefill, decode)."""
from .convert import lm_from_jax, train_state_from_jax
from .model import (DEFAULT_RUN, LM, RunConfig, decode_step, forward,
                    init_cache, init_lm, loss_fn, prefill)

__all__ = ["RunConfig", "DEFAULT_RUN", "LM", "init_lm", "forward", "loss_fn",
           "init_cache", "prefill", "decode_step", "lm_from_jax",
           "train_state_from_jax"]
