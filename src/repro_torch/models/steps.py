"""Step factories for every family (``repro/models/steps.py``): the train
step, prefill and decode, with the reference's input stubs: a VLM takes
precomputed ``patch_embeds`` (B, P, d) before its tokens, an
encoder-decoder precomputed ``frames`` (B, S_enc, d).

The train step is the reference's: ``loss_fn`` under autograd (the fused
chunked cross-entropy at a vocabulary of 32768 or more), microbatches
split interleaved and accumulated in ``cfg.grad_accum_dtype``, the
``warmup_cosine`` rate, AdamW or Adafactor (its statistics over the
reference's stacked leaves: ``nn.stacked``). The port's optimizers write
the state in place, where the reference's return a new one; the step
computes every gradient before it writes anything, so a step that raises
leaves the state as it was (``runtime.fault_tolerance
.FaultTolerantRunner`` retries it)."""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis import cost
from repro_torch.models import nn
from repro_torch.models.encdec import (decoder_apply, encdec_apply,
                                       encdec_cache_specs, encdec_specs,
                                       encoder_apply)
from repro_torch.models.lm import (AUX_KEYS, lm_apply, lm_cache_specs,
                                   lm_specs, zero_aux)
from repro_torch.optim.adafactor import adafactor_init, adafactor_update
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import warmup_cosine

f32 = torch.float32

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3
LM_Z_WEIGHT = 1e-4


def model_specs(cfg) -> dict:
    return encdec_specs(cfg) if cfg.encdec else lm_specs(cfg)


def cache_specs(cfg, batch: int, max_len: int, enc_len: int = 0) -> list:
    if cfg.encdec:
        return encdec_cache_specs(cfg, batch, max_len, enc_len or max_len)
    return lm_cache_specs(cfg, batch, max_len)


def _device(params) -> torch.device:
    return (params["dec_embed"] if "dec_embed" in params
            else params["embed"]).device


def _forward(params, cfg, batch: dict, *, mode, cache=None, cache_index=None,
             logits_slice_last=False, return_hidden=False):
    dev = _device(params)
    positions = None
    if mode == "decode":
        positions = torch.arange(cache_index, cache_index + 1, device=dev)
    if cfg.encdec:
        return encdec_apply(params, cfg, frames=batch.get("frames"),
                            tokens=batch.get("tokens"), mode=mode,
                            cache=cache, cache_index=cache_index,
                            positions=positions)
    tokens = batch.get("tokens")
    embeds = batch.get("patch_embeds")
    if mode != "decode":
        seq = (0 if tokens is None else tokens.shape[1]) + (
            0 if embeds is None else embeds.shape[1])
        positions = torch.arange(seq, device=dev)
    return lm_apply(params, cfg, tokens=tokens, input_embeds=embeds,
                    positions=positions, mode=mode, cache=cache,
                    cache_index=cache_index,
                    logits_slice_last=logits_slice_last,
                    return_hidden=return_hidden)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked CE; labels < 0 are ignored. Returns (loss, z_mean_sq)."""
    lf = logits.to(f32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(f32)
    n = torch.clamp(mask.sum(), min=1.0)
    return (torch.sum((lse - picked) * mask) / n,
            torch.sum((lse * lse) * mask) / n)


def _xent_chunk(xc, lc, head):
    """One chunk's (CE sum, z sum, label count)."""
    logits = nn.logical_constraint(xc @ head.to(xc.dtype),
                                   ("batch", "seq", "vocab"))
    lf = logits.to(f32)
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, lc.clamp(min=0)[..., None])[..., 0]
    mask = (lc >= 0).to(f32)
    return (torch.sum((lse - picked) * mask), torch.sum(lse * lse * mask),
            mask.sum())


def chunked_softmax_xent(x: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The head's product fused with the CE over sequence chunks: x
    (B, S, d) final hidden states, head (d, V), labels (B, S) (< 0
    ignored). Each chunk is checkpointed, so the forward holds one
    (B, chunk, V) tile at a time and the backward recomputes it: the
    (B, S, V) logits never exist (``repro/models/steps.py:87-126``).
    Returns (loss, z_mean_sq)."""
    tot = [torch.zeros((), dtype=f32, device=x.device) for _ in range(3)]
    for c0 in range(0, x.shape[1], chunk):
        part = checkpoint(_xent_chunk, x[:, c0:c0 + chunk],
                          labels[:, c0:c0 + chunk], head, use_reentrant=False)
        tot = [a + b for a, b in zip(tot, part)]
    n = torch.clamp(tot[2], min=1.0)
    return tot[0] / n, tot[1] / n


def loss_fn(params, cfg, batch: dict):
    """(total loss, metrics): the CE plus the z-loss and the MoE aux
    losses, weighted as the reference's."""
    labels = batch["labels"]
    if cfg.vocab_size >= 32768:
        # the fused chunked CE: the (B, S, V) logits are never made
        if cfg.encdec:
            enc_out = encoder_apply(params, cfg, batch["frames"], mode="train")
            (x, head), _ = decoder_apply(params, cfg, batch["tokens"],
                                         enc_out=enc_out, mode="train",
                                         return_hidden=True)
            aux = zero_aux(x.device)
        else:
            (x, head), _, aux = _forward(params, cfg, batch, mode="train",
                                         return_hidden=True)
            x = x[:, -labels.shape[1]:]   # VLM: labels cover the text only
        ce, z = chunked_softmax_xent(x, head, labels)
    else:
        logits, _, aux = _forward(params, cfg, batch, mode="train")
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        ce, z = cross_entropy(logits, labels)
    total = ce + LM_Z_WEIGHT * z
    total = (total + MOE_LB_WEIGHT * aux["moe_lb_loss"]
             + MOE_Z_WEIGHT * aux["moe_z_loss"])
    return total, {"ce": ce, "z": z, **aux}


def default_microbatches(cfg, shape) -> int:
    if shape.microbatch:
        return max(1, shape.global_batch // shape.microbatch)
    tokens = shape.global_batch * shape.seq_len
    # the per-arch activation-memory target (405B takes a far smaller one)
    m = max(1, tokens // cfg.microbatch_tokens)
    while shape.global_batch % m:
        m -= 1
    return m


def make_train_state(cfg, gen: torch.Generator | None = None, device=None,
                     abstract: bool = False) -> dict:
    """{"params", "opt"}: params drawn on ``gen`` (on ``device``, by
    default ``gen``'s), the optimizer state of ``cfg.optimizer`` in
    ``cfg.optstate_dtype``. ``abstract``: every tensor on the ``meta``
    device (shapes and dtypes, no memory)."""
    specs = model_specs(cfg)
    if abstract:
        params = nn.abstract_params(specs)
    else:
        params = nn.init_params(specs, gen, device)
    if cfg.optimizer == "adafactor":
        opt = adafactor_init(params, cfg.optstate_dtype, layout=_stacks(cfg))
    else:
        opt = adamw_init(params, cfg.optstate_dtype)
    return {"params": params, "opt": opt}


def _stacks(cfg) -> Callable:
    """Adafactor's grouping: the reference's stacked leaves."""
    return lambda tree: nn.stacked(tree, cfg)


def make_train_step(cfg, *, num_microbatches: int = 1, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    The batch (tensors or numpy arrays; moved to the params' device) is
    split interleaved into ``num_microbatches`` (microbatch i takes rows
    i, i + m, ...: the reference's (B/m, m) split), each one's gradients
    added into ``cfg.grad_accum_dtype`` accumulators; their mean goes to
    the optimizer, which updates ``state`` in place once every gradient is
    in. metrics: loss, ce, z, the aux losses (microbatch means, float32)
    and lr, as 0-d tensors. The microbatches are ``cost.trips``: an
    ``analysis.cost.CostMode`` counts one of them m times on meta tensors
    (the dry-run), and every one of them runs anywhere else."""
    m = num_microbatches
    update = (functools.partial(adafactor_update, layout=_stacks(cfg))
              if cfg.optimizer == "adafactor" else adamw_update)

    def train_step(state, batch):
        params = state["params"]
        leaves = nn.tree_leaves(params)
        dev = leaves[0].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        gacc = [torch.zeros(p.shape, dtype=cfg.grad_accum_dtype, device=dev)
                for p in leaves]
        macc = {k: torch.zeros((), dtype=f32, device=dev)
                for k in ("loss", "ce", "z", *AUX_KEYS)}
        for i in cost.trips(m, leaves[0]):
            # the batch placement re-pinned on every microbatch
            mb = {k: nn.logical_constraint(
                      v[i::m], ("batch",) + (None,) * (v.dim() - 1))
                  for k, v in batch.items()}
            live = nn.tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                loss, metrics = loss_fn(live, cfg, mb)
                grads = torch.autograd.grad(loss, nn.tree_leaves(live),
                                            allow_unused=True)
            for a, g in zip(gacc, grads):
                if g is not None:
                    a.add_(g.to(a.dtype))
            for k, v in {"loss": loss, **metrics}.items():
                macc[k] += v.detach().to(f32)
        inv = 1.0 / m
        for a in gacc:
            a.mul_(inv)
        metrics = {k: v * inv for k, v in macc.items()}
        lr = warmup_cosine(state["opt"]["step"], peak_lr=peak_lr,
                           warmup=warmup, total=total_steps)
        update(nn.tree_unflatten(params, gacc), state["opt"], params, lr=lr)
        metrics["lr"] = lr
        return state, metrics

    return train_step


def make_prefill_step(cfg, *, batch: int, max_len: int,
                      enc_len: int = 0) -> Callable:
    """prefill(params, inputs) -> (last_token_logits (B, V), cache)."""

    def prefill_step(params, inputs):
        dev = _device(params)
        cache = nn.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
            cache_specs(cfg, batch, max_len, enc_len))
        logits, cache, _ = _forward(params, cfg, inputs, mode="prefill",
                                    cache=cache, logits_slice_last=True)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg) -> Callable:
    """decode(params, cache, inputs, cache_index) -> (logits (B, V), cache).

    Writes slot ``cache_index`` of every layer's cache (its ring slot, its
    SSM state) in place and returns the same cache list."""

    def decode_step(params, cache, inputs, cache_index: int):
        logits, cache, _ = _forward(params, cfg, inputs, mode="decode",
                                    cache=cache, cache_index=int(cache_index))
        return logits[:, -1], cache

    return decode_step


def stub_inputs(cfg, batch: int, seq: int, gen: torch.Generator) -> dict:
    """A prefill's inputs for any family, drawn on ``gen``'s device, with
    the reference's modality stubs (``repro/data/pipeline.py``
    ``synth_lm_batch``): an encoder-decoder takes ``seq`` frame embeddings
    and ``dec_len_ratio`` x ``seq`` tokens, a VLM ``num_patch_tokens``
    patch embeddings and ``seq - num_patch_tokens`` tokens (the projector's
    output; no vision tower), any other model ``seq`` tokens."""
    dev, dt, d = gen.device, cfg.compute_dtype, cfg.d_model

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                             device=dev)

    def embeds(n):
        return torch.randn((batch, n, d), generator=gen, device=dev).to(dt)

    if cfg.encdec:
        ratio = cfg.audio.dec_len_ratio if cfg.audio else 1.0
        return {"frames": embeds(seq), "tokens": tokens(max(1, int(seq * ratio)))}
    if cfg.vlm is not None:
        p = cfg.vlm.num_patch_tokens
        return {"patch_embeds": embeds(p), "tokens": tokens(seq - p)}
    return {"tokens": tokens(seq)}
