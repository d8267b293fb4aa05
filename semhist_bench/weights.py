"""The weights the benchmark makes: the specificity MLP (paper §3.1),
trained here in plain torch on the corpus's labels and handed to both the
program and the reference as arrays.

The architecture and training follow the recipe of
``core/specificity.py``: 1152 -> 512 -> 256 -> 1 with tanh-approximate
GELU and a 2·sigmoid output, Huber loss (delta 0.1) on the threshold,
AdamW at lr 1e-3 with weight decay 0.01, minibatches of 256. The program
only loads them (``specificity_model_from_numpy``), so the reference never
reads weights the program made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from semhist_bench.corpus import torch_seed


def init_params(dims: list[int], seed: int, device) -> list[torch.Tensor]:
    """[w0, b0, w1, b1, ...]: weights (in, out) truncated normal in ±2 std
    with std 1/sqrt(fan_in), biases zero."""
    gen = torch.Generator().manual_seed(torch_seed(seed, 5))
    out = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.empty((a, b), dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        out += [(w / math.sqrt(a)).to(device), torch.zeros(b, device=device)]
    return out


def mlp(params: list[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    h = x
    n = len(params) // 2
    for i in range(n):
        h = h @ params[2 * i] + params[2 * i + 1]
        if i + 1 < n:
            h = torch.nn.functional.gelu(h, approximate="tanh")
    return 2.0 * torch.sigmoid(h[..., 0])


def train_specificity(X: np.ndarray, y: np.ndarray, *, hidden: list[int],
                      steps: int, batch: int, lr: float, seed: int,
                      device) -> dict[str, np.ndarray]:
    """The trained MLP as ``{"w{i}": (in, out), "b{i}": (out,)}`` float32
    arrays."""
    dev = torch.device(device)
    params = init_params([X.shape[1], *hidden, 1], seed, dev)
    for p in params:
        p.requires_grad_(True)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    Xd = torch.as_tensor(X, device=dev)
    yd = torch.as_tensor(y, device=dev)
    gen = torch.Generator(device=dev).manual_seed(torch_seed(seed, 6))
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    for t in range(1, steps + 1):
        idx = torch.randint(0, Xd.shape[0], (batch,), generator=gen,
                            device=dev)
        err = mlp(params, Xd[idx]) - yd[idx]
        loss = torch.where(err.abs() < 0.1, 0.5 * err * err / 0.1,
                           err.abs() - 0.05).mean()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = mi / (1 - b1 ** t)
                vhat = vi / (1 - b2 ** t)
                p.mul_(1 - lr * wd).sub_(lr * mhat / (vhat.sqrt() + eps))
    out = {}
    for i in range(len(params) // 2):
        out[f"w{i}"] = params[2 * i].detach().cpu().numpy()
        out[f"b{i}"] = params[2 * i + 1].detach().cpu().numpy()
    return out
