"""AdamW on trees of tensors (nested dicts and lists, or the flat dict of
named parameters ``core/specificity.py`` passes): the update of
``repro/optim/adamw.py``.

b2 = 0.95, global-norm gradient clipping at 1.0, and decoupled weight decay
added to the step (``delta = m̂ / (√v̂ + eps) + weight_decay · p``), all in
float32; the moments are stored in ``dtype`` (the config's
``optstate_dtype``). Unlike the functional reference, ``adamw_update``
writes the parameters and the moments in place (under ``torch.no_grad``):
no second copy of the model a step. It reads every input before it writes
a leaf, so a caller that computed every gradient first (``steps``
``make_train_step``) never leaves a half-made step behind on an error in
the gradients.
"""

from __future__ import annotations

import torch

from repro_torch.models import nn

f32 = torch.float32


def _device(params):
    leaves = nn.tree_leaves(params)
    return leaves[0].device if leaves else None


def adamw_init(params, dtype=f32) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)  # noqa: E731
    return {"m": nn.tree_map(zeros, params), "v": nn.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def clip_scale(grads: list, grad_clip: float) -> torch.Tensor:
    """min(1, grad_clip / ||g||) over every leaf (the global norm)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32))) for g in grads))
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)


@torch.no_grad()
def adamw_update(
    grads,
    opt_state: dict,
    params,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
):
    """One step in place; returns (params, opt_state), the same objects.
    ``lr`` is a float or a 0-d tensor."""
    step = opt_state["step"] + 1
    flat_g = nn.tree_leaves(grads)
    scale = clip_scale(flat_g, grad_clip) if grad_clip else None
    t = step.to(f32)
    bc1 = 1.0 - torch.tensor(b1, dtype=f32, device=t.device) ** t
    bc2 = 1.0 - torch.tensor(b2, dtype=f32, device=t.device) ** t
    for p, g, m, v in zip(nn.tree_leaves(params), flat_g,
                          nn.tree_leaves(opt_state["m"]),
                          nn.tree_leaves(opt_state["v"])):
        if scale is not None:
            g = g * scale.to(g.dtype)
        gf = g.to(f32)
        m_new = b1 * m.to(f32) + (1 - b1) * gf
        v_new = b2 * v.to(f32) + (1 - b2) * gf * gf
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps) \
            + weight_decay * p.to(f32)
        p.copy_(p.to(f32) - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return params, opt_state
