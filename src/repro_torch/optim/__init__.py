"""Optimisers and gradient compression of the port (counterpart of
:mod:`repro.optim`)."""
from repro_torch.optim import compression
from repro_torch.optim.optimizers import (
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)

__all__ = ["adamw", "adafactor", "OptState", "make_optimizer", "clip_by_global_norm",
           "cosine_schedule", "compression"]
