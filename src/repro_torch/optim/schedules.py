"""Learning-rate schedules as pure functions of the step counter, as
``repro/optim/schedules.py``: the step is a Python int or a 0-d tensor,
and the rate comes back as a 0-d float32 tensor on the step's device."""

from __future__ import annotations

import math

import torch

f32 = torch.float32


def _step(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(f32)
    return torch.tensor(float(step), dtype=f32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    s = _step(step)
    # (s + 1): step 0 must have a nonzero rate or the first update is a no-op
    warm = peak_lr * torch.clamp((s + 1.0) / max(1, warmup), max=1.0)
    frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup, warm, cos)


def constant(step, *, lr: float) -> torch.Tensor:
    return torch.full((), lr, dtype=f32, device=_step(step).device)


def inverse_sqrt(step, *, peak_lr: float, warmup: int) -> torch.Tensor:
    s = torch.clamp(_step(step), min=1.0)
    return peak_lr * torch.minimum(s / max(1, warmup), torch.sqrt(warmup / s))
