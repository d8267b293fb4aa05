"""The plain reference of ``llava-next-8b``'s language model, the KV-batch
VLM of paper §3.2: float32 torch with TF32 off, no kernels, caches or
batching of the program's. It imports nothing of the program.

Published widths: Llama-3-8B's config.json
(https://huggingface.co/meta-llama/Meta-Llama-3-8B/blob/main/config.json),
the backbone of llama3-llava-next-8b: 32 layers, d 4096, 32 query and 8 KV
heads of 128 (GQA; query head h reads KV head h // 4), SwiGLU of 14336,
a vocabulary of 128256 with an untied head, RoPE θ 5e5 without scaling
(the two halves of a head rotated against each other), RMSNorm ε 1e-5
before each block and the head. Departure, as in the program: no vision
tower; the benchmark's seeded stub (``vlmdraw.draw_patches``) gives 2880
patch tokens (anyres, 5 tiles of 576) that enter the first layer as
embeddings. ``SMOKE`` is the program's smoke cut for the CPU tests.

``forward`` works through the judged rows' patches one layer at a time
(one layer's weights in float32 at a time):

  * the prefill, causal over the patches: each layer's rope'd K and V;
  * the Expected-Attention query statistics from the calibration prompts:
    per layer the mean and variance, over both prompts' 32 positions, of
    the rope'd queries of each head;
  * each position's score per (row, KV head),
    ``||v|| · Σ_r exp(μ_r·k / √D + σ²_r·k² / (2D))`` over the KV head's
    query heads r (the exponent clamped to ±30, as the program states),
    and the ``ceil((1 - rate)·P)`` best positions;
  * each prompt's decode: its token t at cache position keep + t attends
    to the kept positions given (the program's own, so its logits are
    judged at its own selection) and to the prompt's tokens up to t; the
    answer logits are the last token's. ``seen(i, parts)``, where given,
    is called with layer i's cache at those kept positions, by part:
    ``{"k": K, "v": V}``, each (N, keep, Hkv, D), in the order the
    positions are given.

``widths(smoke)["press_heads"]`` is the number of heads the press picks
positions for: one a KV head.

With ``low`` the forward is the control (``Rounding``): the weights,
every matrix product's operands and the cache in that type.
"""

from __future__ import annotations

import math

import torch

f32 = torch.float32
bf16 = torch.bfloat16

WIDTHS = dict(layers=32, d=4096, heads=32, kv_heads=8, head_dim=128,
              ff=14336, vocab=128256, theta=500000.0, eps=1e-5, patches=2880,
              press_heads=8)
SMOKE = dict(layers=2, d=64, heads=4, kv_heads=2, head_dim=16, ff=128,
             vocab=256, theta=500000.0, eps=1e-5, patches=8, press_heads=2)
SERVED = bf16            # the weights' and patches' type as served
QUERY_BLOCK = 256        # queries a block of the attention holds


def widths(smoke: bool) -> dict:
    return SMOKE if smoke else WIDTHS


def layout(smoke: bool) -> list[tuple]:
    """The weight tree's leaves: (path, shape, init, dtype)."""
    w = widths(smoke)
    d, H, Hkv, D, F, V = (w["d"], w["heads"], w["kv_heads"], w["head_dim"],
                          w["ff"], w["vocab"])
    out = [("embed", (V, d), "normal", SERVED),
           ("final_norm.scale", (d,), "ones", f32),
           ("head", (d, V), "normal", SERVED)]
    for i in range(w["layers"]):
        p = f"layers.{i}."
        out += [(p + "ln1.scale", (d,), "ones", f32),
                (p + "mixer.wq", (d, H, D), "normal", SERVED),
                (p + "mixer.wk", (d, Hkv, D), "normal", SERVED),
                (p + "mixer.wv", (d, Hkv, D), "normal", SERVED),
                (p + "mixer.wo", (H, D, d), "normal", SERVED),
                (p + "ln2.scale", (d,), "ones", f32),
                (p + "mlp.wi_gate", (d, F), "normal", SERVED),
                (p + "mlp.wi_up", (d, F), "normal", SERVED),
                (p + "mlp.wo", (F, d), "normal", SERVED)]
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x (N, S, H, D) at positions pos (S,); angles in float64."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                         device=x.device) / D)
    ang = pos.to(torch.float64)[:, None] * freqs
    cos = torch.cos(ang).to(f32)[:, None, :]
    sin = torch.sin(ang).to(f32)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class Rounding:
    """Where the control rounds: ``low`` None is the reference itself.
    Otherwise the weights and every matrix product's operands are rounded
    to ``low`` with a scale a tensor (its largest magnitude at ``low``'s
    largest value), and the cache is cast to ``low`` as it is written, as
    a float8 serve cache is."""

    def __init__(self, low=None):
        self.low = low
        self.top = None if low is None else torch.finfo(low).max

    def __call__(self, t):
        if self.low is None:
            return t
        s = t.abs().amax().clamp(min=1e-30) / self.top
        return (t / s).to(self.low).to(f32) * s

    def cache(self, t):
        return t if self.low is None else t.to(self.low).to(f32)


def attend(q, k, v, offset: int, r: Rounding):
    """q (N, T, H, D); k, v (N, S, Hkv, D): query t sees keys 0..offset + t."""
    N, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for n in range(N):
        kn = k[n].permute(1, 0, 2)                           # (Hkv, S, D)
        vn = v[n].permute(1, 0, 2)
        for a in range(0, T, QUERY_BLOCK):
            qb = q[n, a:a + QUERY_BLOCK]
            t = qb.shape[0]
            qb = qb.reshape(t, Hkv, rep, D).permute(1, 2, 0, 3)
            s = torch.einsum("hrtd,hsd->hrts", qb, kn) / math.sqrt(D)
            qpos = offset + torch.arange(a, a + t, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
            o = torch.einsum("hrts,hsd->hrtd", r(torch.softmax(s, dim=-1)),
                             vn)
            out[n, a:a + t] = o.permute(2, 0, 1, 3).reshape(t, H, D)
    return out


def qkv(h, lw, pos, theta, r: Rounding):
    h = r(h)
    q = rope(torch.einsum("nsd,dhk->nshk", h, lw["mixer.wq"]), pos, theta)
    k = rope(torch.einsum("nsd,dhk->nshk", h, lw["mixer.wk"]), pos, theta)
    v = torch.einsum("nsd,dhk->nshk", h, lw["mixer.wv"])
    return r(q), r.cache(k), r.cache(v)


def finish(x, o, lw, eps, r: Rounding):
    """The residual adds of attention output ``o`` and the SwiGLU."""
    x = x + torch.einsum("nshk,hkd->nsd", r(o), lw["mixer.wo"])
    h = r(rmsnorm(x, lw["ln2.scale"], eps))
    g = torch.nn.functional.silu(h @ lw["mlp.wi_gate"]) * (h @ lw["mlp.wi_up"])
    return x + r(g) @ lw["mlp.wo"]


def ea_scores(k, v, mu, var):
    """(N, S, Hkv) scores of k, v (N, S, Hkv, D) under mu, var (Hkv, rep, D)."""
    D = k.shape[-1]
    lin = torch.einsum("nshd,hrd->nshr", k, mu) / math.sqrt(D)
    quad = torch.einsum("nshd,hrd->nshr", k * k, var) / (2.0 * D)
    return torch.exp((lin + quad).clamp(-30.0, 30.0)).sum(-1) * \
        torch.linalg.vector_norm(v, dim=-1)


def forward(weights, patches, calib, *, smoke: bool, rate: float,
            kept=None, prompts=(), low=None, seen=None):
    """``weights(group)`` -> {path: tensor} of one group (``top``,
    ``layers.<i>``); ``patches`` (N, P, d) of the judged rows; ``calib``
    (2, 32) token ids; ``kept`` per layer (N, keep, Hkv) positions the
    decode attends to (None: this forward's own); ``prompts`` token id
    sequences; ``low`` the control's type (``Rounding``); ``seen`` as
    above. Returns (this
    forward's own kept positions per layer, the answer logits (N, V) of
    each prompt)."""
    w = widths(smoke)
    H, Hkv, D, theta, eps = (w["heads"], w["kv_heads"], w["head_dim"],
                             w["theta"], w["eps"])
    rep = H // Hkv
    r = Rounding(low)
    dev = patches.device
    top = {k: t.to(f32) if t.ndim == 1 else r(t.to(f32))
           for k, t in weights("top").items()}
    x = patches.to(f32)
    N, P, _ = x.shape
    keep = max(1, math.ceil(P * (1.0 - rate)))
    xc = top["embed"][calib.to(dev)]
    xps = [top["embed"][torch.as_tensor(p, device=dev).long()][None]
           .expand(N, -1, -1) for p in prompts]
    pos_x = torch.arange(P, device=dev)
    pos_c = torch.arange(calib.shape[1], device=dev)

    own = []
    for i in range(w["layers"]):
        g = weights(f"layers.{i}")
        lw = {k.split(".", 2)[2]: t.to(f32) if t.ndim == 1 else r(t.to(f32))
              for k, t in g.items()}
        del g
        # the press's query statistics, and the calibration's own layer
        hc = rmsnorm(xc, lw["ln1.scale"], eps)
        qc, kc, vc = qkv(hc, lw, pos_c, theta, r)
        qr = qc.reshape(*qc.shape[:2], Hkv, rep, D)
        mu, var = qr.mean(dim=(0, 1)), qr.var(dim=(0, 1), correction=0)
        xc = finish(xc, attend(qc, kc, vc, 0, r), lw, eps, r)
        # the prefill, and the layer's cache under the press
        h = rmsnorm(x, lw["ln1.scale"], eps)
        q, k, v = qkv(h, lw, pos_x, theta, r)
        x = finish(x, attend(q, k, v, 0, r), lw, eps, r)
        best = torch.topk(ea_scores(k, v, mu, var).transpose(1, 2), keep,
                          dim=-1).indices
        own.append(torch.sort(best, dim=-1).values.transpose(1, 2))
        at = (own[-1] if kept is None
              else torch.as_tensor(kept[i], device=dev).long())
        gi = at[..., None].expand(-1, -1, -1, D)
        kk, vk = torch.gather(k, 1, gi), torch.gather(v, 1, gi)
        del q, k, v
        if seen is not None:
            seen(i, {"k": kk, "v": vk})
        for n, xp in enumerate(xps):
            hp = rmsnorm(xp, lw["ln1.scale"], eps)
            pos_p = keep + torch.arange(xp.shape[1], device=dev)
            qp, kp, vp = qkv(hp, lw, pos_p, theta, r)
            o = attend(qp, torch.cat([kk, kp], 1), torch.cat([vk, vp], 1),
                       keep, r)
            xps[n] = finish(xp, o, lw, eps, r)
        del lw, kk, vk
    logits = [r(rmsnorm(xp[:, -1], top["final_norm.scale"], eps))
              @ top["head"] for xp in xps]
    return own, logits
