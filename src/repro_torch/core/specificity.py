"""The specificity model (paper §3.1): predicate embedding -> cosine-distance
threshold. A small MLP (1152 -> 512 -> 256 -> 1, tanh-approximate GELU,
2·sigmoid output) trained with the port's AdamW on hierarchical-label data
built exactly as the paper describes.

``specificity_model_from_numpy`` carries the reference's JAX parameters
(``{"w{i}": (in, out), "b{i}": (out,)}``) into the module, so both packages
can be run on the same weights.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch import nn

from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.device import resolve_device, wait_for
from repro_torch.optim.adamw import adamw_init, adamw_update

f32 = torch.float32


class SpecificityMLP(nn.Module):
    """x (B, d) -> thresholds (B,) in (0, 2) via a scaled sigmoid."""

    def __init__(self, cfg: SpecificityModelConfig):
        super().__init__()
        dims = [cfg.embed_dim, *cfg.hidden, 1]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(f32)
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i + 1 < len(self.layers):
                # jax.nn.gelu defaults to the tanh approximation
                h = nn.functional.gelu(h, approximate="tanh")
        return 2.0 * torch.sigmoid(h[..., 0])  # cosine distance range [0, 2]

    @torch.no_grad()
    def reset_parameters_from(self, gen: torch.Generator) -> None:
        """The reference's initialisation: weights truncated normal in
        ±2 std with std = 1/sqrt(fan_in), biases zero. Drawn from ``gen``;
        JAX's bits cannot be reproduced, only their distribution."""
        for layer in self.layers:
            w = layer.weight
            std = 1.0 / math.sqrt(w.shape[1])
            t = torch.empty(w.shape, dtype=f32)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w.copy_(t * std)
            layer.bias.zero_()


class SpecificityModel:
    """Threshold lookups for numpy predicate embeddings.

    On a CUDA device the copy in, the MLP's layers and the copy out run on
    a stream of the model's own, at the card's greatest priority, shared by
    every thread that plans. Torch's pool streams do not wait on the legacy
    default stream, where the coalescer's flusher scans the store, and the
    flusher reads a scan back only after a blocking wait, so the thresholds
    come back while a scan queued on the default stream still runs,
    whichever thread queued it. A kernel first loaded behind a scan (CUDA
    loads modules lazily) still waits for the whole card, so the MLP's
    kernels must be warm. The read-back waits for the stream first
    (``device.wait_for``), so it holds no other thread's CUDA calls. The
    kernels and their order are the default stream's, so the thresholds
    are bitwise the same."""

    def __init__(self, module: SpecificityMLP, cfg: SpecificityModelConfig):
        self.module, self.cfg = module.eval(), cfg
        self.device = next(module.parameters()).device
        self._stream = None
        if self.device.type == "cuda":
            # it first waits for the parameters' copies on this stream
            _, greatest = torch.cuda.Stream.priority_range()
            self._stream = torch.cuda.Stream(self.device, priority=greatest)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    @torch.no_grad()
    def thresholds(self, pred_embeddings: np.ndarray) -> np.ndarray:
        x = np.asarray(pred_embeddings, np.float32)
        if self.device.type != "cuda":
            return self.module(
                torch.as_tensor(x, device=self.device)).cpu().numpy()
        with torch.cuda.stream(self._stream):
            h = self.module(torch.as_tensor(x, device=self.device))
            wait_for(self._stream)
            return h.cpu().numpy()      # on this stream, as is every step

    def threshold(self, pred_embedding: np.ndarray) -> float:
        return float(self.thresholds(np.asarray(pred_embedding)[None])[0])


def specificity_model_from_numpy(params: dict, cfg: SpecificityModelConfig,
                                 device=None) -> SpecificityModel:
    """A model holding the reference's JAX parameters (as numpy arrays):
    ``w{i}`` is (in, out) there and is transposed into ``nn.Linear``."""
    dev = resolve_device(device)
    module = SpecificityMLP(cfg)
    with torch.no_grad():
        for i, layer in enumerate(module.layers):
            w = np.asarray(params[f"w{i}"], np.float32)
            b = np.asarray(params[f"b{i}"], np.float32)
            if w.shape != (layer.in_features, layer.out_features):
                raise ValueError(f"w{i} {w.shape} does not fit layer "
                                 f"{layer.in_features}->{layer.out_features}")
            layer.weight.copy_(torch.tensor(w.T))
            layer.bias.copy_(torch.tensor(b))
    return SpecificityModel(module.to(dev), cfg)


def train_specificity(
    X: np.ndarray,
    y: np.ndarray,
    cfg: SpecificityModelConfig | None = None,
    *,
    seed: int = 0,
    device=None,
) -> tuple[SpecificityModel, dict]:
    """Huber-on-threshold regression (delta 0.1); returns (model, metrics).

    The initial weights and the minibatch draws come from
    ``torch.Generator``s seeded from ``seed`` (the reference uses JAX keys),
    so the weights differ from the reference's; the validation error agrees
    within the tolerance the tests state."""
    dev = resolve_device(device)
    cfg = cfg or SpecificityModelConfig(embed_dim=X.shape[1])
    init_gen = torch.Generator().manual_seed(seed)
    module = SpecificityMLP(cfg)
    module.reset_parameters_from(init_gen)
    module.to(dev)
    params = dict(module.named_parameters())
    opt = adamw_init(params)

    Xd = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    yd = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    n = X.shape[0]
    n_val = max(64, n // 10)
    Xtr, ytr, Xval, yval = Xd[:-n_val], yd[:-n_val], Xd[-n_val:], yd[-n_val:]

    def loss_fn(xb, yb):
        err = module(xb) - yb
        huber = torch.where(err.abs() < 0.1, 0.5 * err * err / 0.1,
                            err.abs() - 0.05)
        return huber.mean()

    batch_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    losses = []
    for _ in range(cfg.steps):
        idx = torch.randint(0, Xtr.shape[0], (cfg.batch,), generator=batch_gen,
                            device=dev)
        loss = loss_fn(Xtr[idx], ytr[idx])
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        adamw_update(grads, opt, params, lr=cfg.lr, weight_decay=0.01)
        losses.append(loss.detach())
    losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(1)
    with torch.no_grad():
        val_mae = float((module(Xval) - yval).abs().mean())
    metrics = {
        "train_loss_final": float(np.mean(losses[-50:])),
        "val_mae": val_mae,
        "train_s": time.perf_counter() - t0,
        "steps": cfg.steps,
    }
    return SpecificityModel(module, cfg), metrics
