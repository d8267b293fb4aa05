"""Flash attention with a hand-written backward: the training route of
``layers.sdpa``, as ``repro/models/flash_ref.py``.

``FlashAttention`` saves only (q, k, v, out, lse) and recomputes the
scores chunk pair by chunk pair in the backward, so no (Sq, Sk) tensor
lives in either pass. Its forward is the flash kernel
(``kernels/flash_attention``, which writes the row log-sum-exp beside the
output) on a CUDA tensor, which raises for a shape the kernel does not
take, and the reference's chunked online softmax in plain torch on the CPU
or when asked (``use_kernel=False``: ``layers.sdpa_plain``'s route, MLA's,
whose q/k and v widths differ). Its backward is the flash backward kernel
(``kernels/flash_attention/backward.py``) on a CUDA tensor, likewise with
no plain fallback, and ``flash_backward`` elsewhere: the reference's
``flash_bwd`` (``flash_ref.py:110-179``) in plain torch, which the
reference computes in XLA, outside any Pallas kernel (the Pallas package
has no backward kernel). ``use_kernel=False`` keeps both passes plain on
any device.

Masks are additive float32 biases built per chunk pair from positions
(``_chunk_bias``), never a broadcast boolean (Sq, Sk) tensor. A chunk
pair whose every (query, key) is masked is skipped: it adds exactly zero
to every sum (its probabilities are exp(-1e30 - lse) = 0), where the
reference's scan computes it.

GQA layout: q (B, Sq, H, D) with H = Hkv * rep; k (B, Sk, Hkv, D), v
(B, Sk, Hkv, Dv); lse (B, H, Sq) in float32. The queries start at
position 0 (train and prefill), as there.
"""

from __future__ import annotations

import math

import torch

f32 = torch.float32
NEG_INF = -1e30  # finite -inf stand-in: exp() = 0 with no NaN from inf - inf


def _chunk_bias(q_pos, k_pos, *, causal: bool, window: int | None
                ) -> torch.Tensor:
    """(qc, kc) additive float32 bias for one chunk pair; positions
    absolute."""
    ok = torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG_INF).to(f32)


def _pairs(sq: int, sk: int, q_chunk: int, kv_chunk: int, causal: bool,
           window: int | None):
    """The chunk pairs ((q0, q1), (k0, k1)) that hold a visible key, for
    each q chunk (forward) in kv order."""
    out = {}
    for q0 in range(0, sq, q_chunk):
        q1 = min(sq, q0 + q_chunk)
        out[(q0, q1)] = [
            (k0, min(sk, k0 + kv_chunk)) for k0 in range(0, sk, kv_chunk)
            if not causal or (k0 <= q1 - 1 and (
                window is None or min(sk, k0 + kv_chunk) - 1 > q0 - window))]
    return out


def _heads(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, Hkv, rep, D) (a view of a contiguous x)."""
    B, S, H, D = x.shape
    return x.reshape(B, S, hkv, H // hkv, D)


def flash_forward_plain(q, k, v, *, causal: bool, window: int | None,
                        scale: float, q_chunk: int = 1024,
                        kv_chunk: int = 1024):
    """The reference's chunked online-softmax forward
    (``flash_ref.py:53-100``): (out (B, Sq, H, Dv) in q's dtype, lse
    (B, H, Sq) float32)."""
    B, sq, H, _ = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // hkv
    dev = q.device
    out = torch.empty((B, sq, H, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, hkv, rep, sq), dtype=f32, device=dev)
    q5 = _heads(q, hkv)
    for (q0, q1), kv in _pairs(sq, sk, q_chunk, kv_chunk, causal,
                               window).items():
        qc = q5[:, q0:q1].to(f32)
        q_pos = torch.arange(q0, q1, device=dev)
        shape = (B, hkv, rep, q1 - q0)
        m = torch.full(shape, NEG_INF, dtype=f32, device=dev)
        l = torch.zeros(shape, dtype=f32, device=dev)
        acc = torch.zeros((*shape, dv), dtype=f32, device=dev)
        for k0, k1 in kv:
            bias = _chunk_bias(q_pos, torch.arange(k0, k1, device=dev),
                               causal=causal, window=window)
            s = torch.einsum("bqhrd,bkhd->bhrqk", qc,
                             k[:, k0:k1].to(f32)) * scale + bias
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            vc = v[:, k0:k1]
            acc = acc * corr[..., None] + torch.einsum(
                "bhrqk,bkhd->bhrqd", p.to(vc.dtype).to(f32), vc.to(f32))
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, q0:q1] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4) \
            .reshape(B, q1 - q0, H, dv).to(q.dtype)
        lse[..., q0:q1] = m + torch.log(l_safe)
    return out, lse.view(B, H, sq)


def flash_backward(q, k, v, out, lse, dout, *, causal: bool,
                   window: int | None, scale: float, q_chunk: int = 1024,
                   kv_chunk: int = 1024):
    """The reference's ``flash_bwd`` in plain torch: for each kv chunk, the
    q chunks that see it; s recomputed, p = exp(s - lse), ds = p (dp -
    delta) scale. dk, dv and dq in float32, each cast to its input's
    dtype."""
    B, sq, H, D = q.shape
    sk, hkv, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // hkv
    dev = q.device
    q5 = _heads(q, hkv)
    do5 = _heads(dout, hkv).to(f32)
    lse4 = lse.view(B, hkv, rep, sq)
    delta = torch.einsum("bqhrd,bqhrd->bhrq", do5, _heads(out, hkv).to(f32))
    dq = torch.zeros((B, sq, hkv, rep, D), dtype=f32, device=dev)
    dk = torch.empty((B, sk, hkv, D), dtype=f32, device=dev)
    dv = torch.empty((B, sk, hkv, dv_), dtype=f32, device=dev)
    pairs = _pairs(sq, sk, q_chunk, kv_chunk, causal, window)
    for k0 in range(0, sk, kv_chunk):
        k1 = min(sk, k0 + kv_chunk)
        kc, vc = k[:, k0:k1].to(f32), v[:, k0:k1].to(f32)
        k_pos = torch.arange(k0, k1, device=dev)
        dk_j = torch.zeros((B, k1 - k0, hkv, D), dtype=f32, device=dev)
        dv_j = torch.zeros((B, k1 - k0, hkv, dv_), dtype=f32, device=dev)
        for (q0, q1), kv in pairs.items():
            if (k0, k1) not in kv:
                continue
            qc, do_c = q5[:, q0:q1].to(f32), do5[:, q0:q1]
            bias = _chunk_bias(torch.arange(q0, q1, device=dev), k_pos,
                               causal=causal, window=window)
            # in place where the reference makes new arrays: the same
            # operations in the same order, a third of the temporaries
            s = torch.einsum("bqhrd,bkhd->bhrqk", qc, kc).mul_(scale)
            p = s.add_(bias).sub_(lse4[..., q0:q1, None]).exp_()
            dp = torch.einsum("bqhrd,bkhd->bhrqk", do_c, vc)
            ds = dp.sub_(delta[..., q0:q1, None]).mul_(p).mul_(scale)
            dv_j += torch.einsum("bhrqk,bqhrd->bkhd", p, do_c)
            dk_j += torch.einsum("bhrqk,bqhrd->bkhd", ds, qc)
            dq[:, q0:q1] += torch.einsum("bhrqk,bkhd->bqhrd", ds, kc)
        dk[:, k0:k1] = dk_j
        dv[:, k0:k1] = dv_j
    return (dq.view(B, sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """out = softmax(q k^T scale + mask) v with the flash backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_chunk, kv_chunk,
                use_kernel):
        # autograd runs forward with grad mode off: the kernel's guard
        # against an accidental differentiation lets this call through. A
        # shape the kernel does not take raises there: no plain fallback
        if use_kernel and q.device.type == "cuda":
            from repro_torch.kernels.flash_attention import kernel

            out, lse = kernel.flash_fwd(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)
        elif use_kernel:
            # the kernel's stand-in on the CPU and the meta device (the
            # dry-run), counted as one fused op with the kernel's FLOPs
            # (analysis/cost.py)
            from repro_torch.analysis import cost

            pairs = cost.visible_pairs(q.shape[1], k.shape[1],
                                       causal=causal, window=window)
            out, lse = cost.fused("flash_attention", flash_forward_plain, q,
                                  k, v, flops=cost.attention_flops(q, v,
                                                                   pairs),
                                  causal=causal, window=window,
                                  scale=scale, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
        else:
            out, lse = flash_forward_plain(q, k, v, causal=causal,
                                           window=window, scale=scale,
                                           q_chunk=q_chunk,
                                           kv_chunk=kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, scale, q_chunk, kv_chunk, use_kernel)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale, q_chunk, kv_chunk, use_kernel = ctx.cfg
        if use_kernel and q.device.type == "cuda":
            # the backward kernel, or a raise: no plain fallback
            from repro_torch.kernels.flash_attention import backward

            dq, dk, dv = backward.flash_bwd(
                q, k, v, out, lse,
                dout if dout.stride(-1) == 1 else dout.contiguous(),
                causal=causal, window=window, scale=scale)
        elif use_kernel:
            # the kernel's stand-in on the CPU and the meta device, counted
            # as one fused op with the kernel's FLOPs
            from repro_torch.analysis import cost

            pairs = cost.visible_pairs(q.shape[1], k.shape[1],
                                       causal=causal, window=window)
            dq, dk, dv = cost.fused(
                "flash_attention_bwd", flash_backward, q, k, v, out, lse,
                dout, flops=cost.attention_bwd_flops(q, v, pairs),
                causal=causal, window=window, scale=scale, q_chunk=q_chunk,
                kv_chunk=kv_chunk)
        else:
            dq, dk, dv = flash_backward(q, k, v, out, lse, dout,
                                        causal=causal, window=window,
                                        scale=scale, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_ref(q, k, v, *, causal=True, window=None, scale=None,
                        q_chunk=1024, kv_chunk=1024,
                        use_kernel=True) -> torch.Tensor:
    """The entry point, as the reference's: chunks of at most q_chunk
    queries and kv_chunk keys; the queries start at position 0.
    ``use_kernel=False`` keeps the forward in plain torch on the card too
    (``layers.sdpa_plain``'s route)."""
    sq, sk = q.shape[1], k.shape[1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))
    return FlashAttention.apply(q, k, v, bool(causal), window, scale,
                                min(q_chunk, sq), min(kv_chunk, sk),
                                use_kernel)
