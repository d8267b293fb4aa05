"""Mamba2 (SSD: state-space duality) blocks: the chunked train and prefill
scan and the O(1)-state single-token decode, as ``repro/models/ssm.py``.
Used by ``mamba2-130m`` and the SSM layers of ``jamba-v0.1-52b``.

The chunked algorithm follows Dao & Gu 2024 (arXiv:2405.21060): the
quadratic attention-like form inside chunks of length ``chunk``, a linear
recurrence across chunk boundaries. All recurrence math runs in float32;
projections in the compute dtype. The reference runs SSD in plain JAX
outside any Pallas kernel, and this is plain torch in the same way: one
chunk's (B, H, Lc, Lc) tensors live at a time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import nn
from repro_torch.models.layers import rmsnorm, rmsnorm_specs

f32 = torch.float32


def ssm_dims(cfg) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return dict(d_inner=d_inner, nheads=nheads, conv_dim=conv_dim,
                G=s.n_groups, N=s.d_state, P=s.head_dim, d_conv=s.d_conv)


def mamba_specs(cfg) -> dict:
    s = cfg.ssm
    dm = ssm_dims(cfg)
    d = cfg.d_model
    dt = cfg.param_dtype
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    in_dim = 2 * dm["d_inner"] + 2 * dm["G"] * dm["N"] + dm["nheads"]
    return {
        "in_proj": nn.dense((d, in_dim), (emb, "mlp"), dt),
        "conv_w": nn.dense((s.d_conv, dm["conv_dim"]), ("conv", "mlp"), dt,
                           scale=0.5),
        "conv_b": nn.zeros((dm["conv_dim"],), ("mlp",), f32),
        "dt_bias": nn.zeros((dm["nheads"],), ("ssm_heads",), f32),
        "A_log": nn.ones((dm["nheads"],), ("ssm_heads",), f32),
        "D": nn.ones((dm["nheads"],), ("ssm_heads",), f32),
        "norm": rmsnorm_specs(dm["d_inner"]),
        "out_proj": nn.dense((dm["d_inner"], d), ("mlp", emb), dt),
    }


def make_ssm_cache_specs(cfg, batch: int) -> dict:
    dm = ssm_dims(cfg)
    return {
        "conv": nn.zeros((batch, dm["d_conv"] - 1, dm["conv_dim"]),
                         ("batch", None, "mlp"), cfg.compute_dtype),
        "state": nn.zeros((batch, dm["nheads"], dm["P"], dm["N"]),
                          ("batch", "ssm_heads", None, None), f32),
    }


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., Lc, H) -> the causal decay matrix in log space
    (..., H, Lc, Lc)."""
    Lc = dA.shape[-2]
    cum = torch.cumsum(dA, dim=-2).movedim(-1, -2)           # (..., H, Lc)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(Lc, device=dA.device)
    return torch.where(i[:, None] >= i[None, :], diff, -torch.inf)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int, h0=None, out_dtype=f32):
    """x (B, S, H, P), dt (B, S, H) (softplus'd), A (H,) (negative),
    Bm/Cm (B, S, G, N), all float32. Returns (y (B, S, H, P) in
    ``out_dtype``, the final state (B, H, P, N)): one chunk at a time,
    the state carried across chunks."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Lc = min(chunk, S)
    h = (torch.zeros((B, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = torch.empty((B, S, H, P), dtype=out_dtype, device=x.device)
    for c0 in range(0, S, Lc):
        xk, dtk = x[:, c0:c0 + Lc], dt[:, c0:c0 + Lc]
        Bk, Ck = Bm[:, c0:c0 + Lc], Cm[:, c0:c0 + Lc]
        n = xk.shape[1]
        if n < Lc:      # the ragged last chunk, zero-padded as the reference
            pad = (0, 0, 0, 0, 0, Lc - n)
            xk, Bk, Ck = F.pad(xk, pad), F.pad(Bk, pad), F.pad(Ck, pad)
            dtk = F.pad(dtk, (0, 0, 0, Lc - n))
        dA = dtk * A                                         # (B,Lc,H)
        xdt = xk * dtk[..., None]
        cum = torch.cumsum(dA, dim=1)
        last = cum[:, -1:, :]
        Ldec = torch.exp(_segsum(dA))                        # (B,H,Lc,Lc)
        scores = torch.einsum("bign,bjgn->bgij", Ck, Bk)     # (B,G,Lc,Lc)
        scores_h = torch.repeat_interleave(scores, rep, dim=1)
        y_intra = torch.einsum("bhij,bjhp->bihp", scores_h * Ldec, xdt)
        Ch = torch.repeat_interleave(Ck, rep, dim=2)         # (B,Lc,H,N)
        y_inter = torch.einsum("blhn,bhpn,blh->blhp", Ch, h, torch.exp(cum))
        decay_to_end = torch.exp(last - cum)                 # (B,Lc,H)
        Bh = torch.repeat_interleave(Bk, rep, dim=2)
        st = torch.einsum("blhp,blhn,blh->bhpn", xdt, Bh, decay_to_end)
        h = h * torch.exp(last[:, 0, :])[:, :, None, None] + st
        ys[:, c0:c0 + n] = (y_intra + y_inter)[:, :n].to(out_dtype)
    return ys, h


def ssd_decode_step(x, dt, A, Bm, Cm, state):
    """x (B, H, P), dt (B, H), A (H,), Bm/Cm (B, G, N), state (B, H, P, N)
    -> (y (B, H, P), the new state)."""
    rep = x.shape[1] // Bm.shape[1]
    dA = torch.exp(dt * A)                                   # (B,H)
    Bh = torch.repeat_interleave(Bm, rep, dim=1)             # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    upd = (dt[..., None] * x)[..., None] * Bh[:, :, None, :]
    state = state * dA[:, :, None, None] + upd
    return torch.einsum("bhpn,bhn->bhp", state, Ch), state


def mamba_apply(
    p: dict,
    x: torch.Tensor,               # (B, S, d)
    *,
    cfg,
    cache: dict | None = None,
    mode: str = "prefill",         # train | prefill | decode
    **_,
) -> tuple[torch.Tensor, dict | None]:
    """Prefill starts from a zero state and, with a cache, leaves the last
    d_conv - 1 conv inputs and the final state in it; decode advances both
    by one token. Caches are written in place. Train is the prefill with
    no cache: the SSD scan keeps no state, and autograd differentiates it
    (every op is plain torch)."""
    s = cfg.ssm
    dm = ssm_dims(cfg)
    B, S, d = x.shape
    di, H, P, G, N = dm["d_inner"], dm["nheads"], dm["P"], dm["G"], dm["N"]

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xin, Braw, Craw, dt_raw = torch.split(
        zxbcdt, [di, di, G * N, G * N, H], dim=-1)
    conv_in = torch.cat([xin, Braw, Craw], dim=-1)           # (B,S,conv_dim)

    if mode == "decode":
        assert cache is not None and S == 1
        hist = torch.cat([cache["conv"].to(x.dtype), conv_in], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", hist[:, -s.d_conv:, :],
                                p["conv_w"].to(x.dtype)) \
            + p["conv_b"].to(x.dtype)
        conv_out = F.silu(conv_out.to(f32))[:, None, :]      # (B,1,c)
        cache["conv"].copy_(hist[:, 1:, :].to(cache["conv"].dtype))
    else:
        # causal depthwise conv as a shift-accumulate
        pad_in = F.pad(conv_in, (0, 0, s.d_conv - 1, 0))
        conv_out = torch.zeros(conv_in.shape, dtype=f32, device=x.device)
        for i in range(s.d_conv):
            conv_out = conv_out + (
                pad_in[:, i:i + S, :] * p["conv_w"][i].to(x.dtype)).to(f32)
        conv_out = F.silu(conv_out + p["conv_b"])
        if cache is not None:
            tail = conv_in[:, -(s.d_conv - 1):, :].to(cache["conv"].dtype)
            cache["conv"][:, -tail.shape[1]:] = tail

    xs = conv_out[..., :di].reshape(B, -1, H, P)
    Bs = conv_out[..., di:di + G * N].reshape(B, -1, G, N)
    Cs = conv_out[..., di + G * N:].reshape(B, -1, G, N)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))

    if mode == "decode":
        y1, state = ssd_decode_step(xs[:, 0], dt[:, 0], A, Bs[:, 0],
                                    Cs[:, 0], cache["state"])
        cache["state"].copy_(state)
        y = y1[:, None]
    else:
        y, hT = ssd_scan(xs, dt, A, Bs, Cs, s.chunk,
                         out_dtype=cfg.compute_dtype)
        if cache is not None:
            cache["state"].copy_(hT)

    y = y + xs * p["D"][:, None]
    y = y.reshape(B, -1, di)
    y = rmsnorm(p["norm"], (y * F.silu(z.to(f32))).to(x.dtype), cfg.rms_eps)
    return y @ p["out_proj"].to(x.dtype), cache
