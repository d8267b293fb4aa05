"""AdamW on dictionaries of tensors, the same update as ``repro.optim.adamw``.

b2 = 0.95, global-norm gradient clipping at 1.0, and decoupled weight decay
added to the step (``delta = m̂ / (√v̂ + eps) + weight_decay · p``), all in
float32. Unlike the functional reference, ``adamw_update`` updates the
parameters and the moments in place (under ``torch.no_grad``) — no second
copy of the model per step — and returns them for symmetry.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    return {
        "m": {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=f32) for k, p in params.items()},
        "step": 0,
    }


@torch.no_grad()
def adamw_update(
    grads: dict[str, torch.Tensor],
    opt_state: dict,
    params: dict[str, torch.Tensor],
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> tuple[dict[str, torch.Tensor], dict]:
    step = opt_state["step"] + 1
    scale = None
    if grad_clip:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                               for g in grads.values()))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    bc1 = 1.0 - torch.tensor(b1, dtype=f32) ** step
    bc2 = 1.0 - torch.tensor(b2, dtype=f32) ** step
    for name, p in params.items():
        g = grads[name].to(f32)
        if scale is not None:
            g = g * scale
        m, v = opt_state["m"][name], opt_state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mhat = m / bc1.to(m.device)
        vhat = v / bc2.to(v.device)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
    opt_state["step"] = step
    return params, opt_state
