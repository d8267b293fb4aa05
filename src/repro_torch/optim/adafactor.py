"""Adafactor (Shazeer & Stern 2018) with momentum, the PaLM/T5 recipe of
``repro/optim/adafactor.py``: a leaf of rank 2 or more keeps one row and
one column statistic of its second moment instead of the full tensor
(``llama3-405b`` trains with it), the momentum in ``momentum_dtype``.

The reference stacks a period position's layers into one leaf, so its
statistics and its RMS clip span every repeat: a per-layer norm scale is a
(repeats, d) leaf there, factored. The port keeps a dict a layer, and
``make_train_step`` passes ``layout=nn.stacked`` to group the leaves back
into the reference's stacks, so the state and the update are the
reference's. As ``adamw``, the update writes the parameters and the state
in place (under ``torch.no_grad``) and returns the same objects.
"""

from __future__ import annotations

import torch

from repro_torch.models import nn

f32 = torch.float32


def _factored(shape) -> bool:
    return len(shape) >= 2


def _f32(x) -> torch.Tensor:
    """A grouped leaf in float32: a ``Stack``'s repeats stacked."""
    if isinstance(x, nn.Stack):
        return torch.stack([t.to(f32) for t in x.xs])
    return x.to(f32)


def _write(x, new: torch.Tensor) -> None:
    for t, n in zip(x.xs, new) if isinstance(x, nn.Stack) else [(x, new)]:
        t.copy_(n)


def adafactor_init(params, momentum_dtype=torch.bfloat16,
                   layout=None) -> dict:
    """``layout(tree)`` groups the leaves as the reference stacks them
    (``nn.stacked``): each group keeps one pair of statistics over its
    stacked shape, as the reference's stacked leaf does, and ``vr`` and
    ``vc`` are trees of the grouped shape. Without it, every leaf is its
    own group."""
    grouped = params if layout is None else layout(params)

    def vrow(x):
        shape = x.shape[:-1] if _factored(x.shape) else x.shape
        return torch.zeros(shape, dtype=f32, device=x.device)

    def vcol(x):
        shape = ((*x.shape[:-2], x.shape[-1]) if _factored(x.shape)
                 else (0,))
        return torch.zeros(shape, dtype=f32, device=x.device)

    leaves = nn.tree_leaves(params)
    return {
        "m": nn.tree_map(lambda p: torch.zeros(p.shape, dtype=momentum_dtype,
                                               device=p.device), params),
        "vr": nn.tree_map(vrow, grouped),
        "vc": nn.tree_map(vcol, grouped),
        "step": torch.zeros((), dtype=torch.int32,
                            device=leaves[0].device if leaves else None),
    }


@torch.no_grad()
def adafactor_update(
    grads,
    opt_state: dict,
    params,
    *,
    lr,
    b1: float = 0.9,
    decay: float = 0.8,       # beta2(t) = 1 - t^-decay
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 1e-4,
    layout=None,
):
    """One step in place over ``layout``'s groups (``adafactor_init``);
    returns (params, opt_state), the same objects."""
    group = (lambda t: t) if layout is None else layout
    step = opt_state["step"] + 1
    beta2 = 1.0 - step.to(f32) ** (-decay)
    for p, g, m, vr, vc in zip(
            *(nn.tree_leaves(group(t)) for t in (params, grads,
                                                 opt_state["m"])),
            nn.tree_leaves(opt_state["vr"]), nn.tree_leaves(opt_state["vc"])):
        gf = _f32(g)
        g2 = gf * gf + eps
        if _factored(gf.shape):
            vr_new = beta2 * vr + (1 - beta2) * g2.mean(dim=-1)
            vc_new = beta2 * vc + (1 - beta2) * g2.mean(dim=-2)
            # V_ij ~= vr_i vc_j / mean(vr): the rank-1 reconstruction
            r_fac = torch.rsqrt(vr_new / torch.clamp(
                vr_new.mean(dim=-1, keepdim=True), min=eps) + eps)
            c_fac = torch.rsqrt(vc_new + eps)
            u = gf * r_fac[..., None] * c_fac[..., None, :]
        else:
            vr_new = beta2 * vr + (1 - beta2) * g2
            vc_new = vc
            u = gf / torch.sqrt(vr_new + eps)
        # update clipping by RMS (Adafactor's stabiliser), over the group
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        m_new = b1 * _f32(m) + (1 - b1) * u
        pf = _f32(p)
        _write(p, pf - lr * (m_new + weight_decay * pf))
        _write(m, m_new)
        vr.copy_(vr_new)
        if vc.numel():
            vc.copy_(vc_new)
    opt_state["step"] = step
    return params, opt_state
