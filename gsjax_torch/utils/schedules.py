"""Learning-rate schedules.

Counterpart of ``gsjax.utils.schedules``: :func:`expon_lr_schedule` is the
Plenoxels/JaxNeRF log-lerp decay with a sine delay ramp the reference uses
for the xyz learning rate (reference: utils/general_utils.py:29-62,
scene/gaussian_model.py:164-175), computed in float32 as gsjax does.
"""

from __future__ import annotations

import math

import torch


def expon_lr_schedule(
    lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1_000_000
):
    """Return ``f(step) -> lr`` (a 0-d float32 CPU tensor) with log-linear
    interpolation lr_init -> lr_final. Returns 0 for negative steps or when
    both endpoints are 0 (parameter disabled), matching the reference
    helper. Every operation runs in float32, in gsjax's order."""
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: torch.zeros((), dtype=torch.float32)

    log_init = math.log(lr_init)
    log_final = math.log(lr_final)

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            )
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        lr = torch.exp(log_init * (1 - t) + log_final * t)
        return torch.where(step < 0, torch.zeros_like(lr), delay * lr)

    return schedule
