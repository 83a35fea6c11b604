"""The optimizer of the LM stack (the JAX package's ``repro.optim``)."""
from .adamw import (OptConfig, TornStateError, Workspace, adamw_update,
                    clip_by_global_norm, global_norm, init_opt, schedule)

__all__ = ["OptConfig", "init_opt", "adamw_update", "schedule",
           "clip_by_global_norm", "global_norm", "TornStateError",
           "Workspace"]
