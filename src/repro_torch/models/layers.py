"""Transformer building blocks: RMSNorm, RoPE, GQA/SWA attention, MLA, the
SwiGLU MLP and MoE, at the reference's (B, S, H, D) layout.

As in ``repro/models/layers.py``:
  * ``*_specs(cfg) -> dict[str, ParamSpec]``
  * ``*_apply(params, x, ...) -> y``.

There is no ``impl`` switch: ``sdpa`` lets the tensor's device decide. A
CUDA tensor goes to the hand-written flash kernel (Sq > 1) or the decode
kernel (Sq == 1); a CPU tensor goes to their plain version,
``sdpa_reference``, which both kernels are held against. MLA alone takes
``sdpa_plain`` on every device (the reference's XLA dispatch): its q/k and
v head dims differ (192 and 128; 576 and 512 in the absorbed decode), a
shape neither kernel takes, so the route is chosen by the layer, before any
launch. ``plain_attention_calls`` counts those calls.

Training (grad mode on and an input that requires grad) takes the
``flash_ref.FlashAttention`` route for more than one query: the flash
kernel's forward (with the rows' log-sum-exp) and the flash backward on
the card; on the CPU the reference's own split, direct attention up to
1024 queries and ``flash_ref`` past that. ``sdpa_plain`` in training keeps
its split with ``flash_ref``'s plain forward past 1024 queries. The
mixers take ``mode="train"``: the prefill's computation with no cache.
"""

from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.models import nn

f32 = torch.float32
MLP_CHUNK = 16384      # tokens per MLP pass: bounds the (tokens, d_ff) transients

# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_specs(d: int) -> dict:
    return {"scale": nn.ones((d,), ("embed",), f32)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    h = x.to(f32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    h = h * torch.rsqrt(var + eps)
    return (h * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=f32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Angles in
    float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    angles = positions[..., None].to(f32) * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Scaled dot-product attention
# ---------------------------------------------------------------------------


def _causal_mask_bias(q_pos, k_pos, window: int | None) -> torch.Tensor:
    """(Q, K) additive bias in float32. window=None -> plain causal."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > (q_pos[:, None] - window)
    return torch.where(ok, 0.0, -math.inf).to(f32)


def sdpa_reference(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, Hkv, D)
    v: torch.Tensor,            # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,          # absolute position of q[0]
    kv_valid=None,              # int or (B,) number of valid kv positions
    scale: float | None = None,
) -> torch.Tensor:
    """Direct attention: the plain version of both attention kernels. The
    queries sit at positions q_offset .. q_offset + Sq - 1. A sequence whose
    ``kv_valid`` is 0 gets a zero output row."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qf = (q * scale).to(f32).reshape(B, Sq, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.to(f32))
    Sk = k.shape[1]
    k_pos = torch.arange(Sk, device=q.device)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    if causal:
        logits = logits + _causal_mask_bias(q_pos, k_pos, window)
    if kv_valid is not None:
        valid = torch.as_tensor(kv_valid, device=q.device).reshape(-1, 1)
        live = k_pos[None, :] < valid                         # (B|1, Sk)
        bias = torch.where(live, 0.0, -math.inf).to(f32)
        logits = logits + bias[:, None, None, None, :]        # (B|1, .., Sk)
    probs = torch.softmax(logits, dim=-1)
    if kv_valid is not None:
        # a sequence with no valid slot attends to nothing: a zero row (the
        # decode kernel's answer), not the NaN of a softmax over all -inf
        probs = torch.where(live.any(dim=1)[:, None, None, None, None],
                            probs, 0.0)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.to(f32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def sdpa_chunked(q, k, v, *, causal=True, window=None, q_offset=0,
                 scale=None, q_chunk=1024, kv_chunk=1024) -> torch.Tensor:
    """Flash-style online-softmax attention in plain torch: the (Sq, Sk)
    score matrix is built one (q_chunk, kv_chunk) tile at a time."""
    B, Sq, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, q_chunk):
        qc = (q[:, q0:q0 + q_chunk] * scale).to(f32)
        nq = qc.shape[1]
        qc = qc.reshape(B, nq, Hkv, rep, D)
        q_pos = torch.arange(q0, q0 + nq, device=q.device) + q_offset
        m = torch.full((B, Hkv, rep, nq), -math.inf, device=q.device)
        l = torch.zeros((B, Hkv, rep, nq), device=q.device)
        acc = torch.zeros((B, Hkv, rep, nq, Dv), device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            k_pos = torch.arange(k0, min(Sk, k0 + kv_chunk), device=q.device)
            s = torch.einsum("bqhrd,bkhd->bhrqk", qc,
                             k[:, k0:k0 + kv_chunk].to(f32))
            if causal:
                ok = k_pos[None, :] <= q_pos[:, None]
                if window is not None:
                    ok &= k_pos[None, :] > q_pos[:, None] - window
            else:
                ok = torch.ones((nq, len(k_pos)), dtype=torch.bool,
                                device=q.device)
            s = torch.where(ok, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhrqk,bkhd->bhrqd", p, v[:, k0:k0 + kv_chunk].to(f32))
            m = m_new
        o = acc / l.clamp_min(1e-30)[..., None]            # (B,Hkv,rep,nq,Dv)
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, nq, H, Dv).to(q.dtype)
    return out


def sdpa_decode_chunked(q, k, v, *, kv_valid=None, kv_chunk=8192,
                        scale=None) -> torch.Tensor:
    """Flash-decode in plain torch: online softmax over cache chunks, so a
    long (possibly fp8) cache is upcast one chunk at a time."""
    B, _, H, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // Hkv
    scale = scale or (1.0 / math.sqrt(D))
    qf = (q[:, 0].reshape(B, Hkv, rep, D) * scale).to(f32)
    valid = torch.as_tensor(Sk if kv_valid is None else kv_valid,
                            device=q.device).reshape(-1, 1)
    m = torch.full((B, Hkv, rep), -1e30, device=q.device)
    l = torch.zeros((B, Hkv, rep), device=q.device)
    acc = torch.zeros((B, Hkv, rep, Dv), device=q.device)
    for k0 in range(0, Sk, kv_chunk):
        kc, vc = k[:, k0:k0 + kv_chunk].to(f32), v[:, k0:k0 + kv_chunk].to(f32)
        pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
        bias = torch.where(pos[None, :] < valid, 0.0, -1e30)     # (B|1, kc)
        s = torch.einsum("bhrd,bkhd->bhrk", qf, kc) + bias[:, None, None, :]
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhrk,bkhd->bhrd", p, vc)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, Dv).to(q.dtype)


plain_attention_calls = 0   # sdpa_plain calls in this process (MLA's route)
_count_lock = threading.Lock()   # bumped from any thread, as the kernels'


def sdpa_plain(q, k, v, *, causal=True, window=None, q_offset=0,
               kv_valid=None, scale=None) -> torch.Tensor:
    """The reference's XLA dispatch (``repro/models/layers.py:267-289``) in
    plain torch, on any device: the chunked decode for a single token over
    more than 8192 slots, direct attention for a decode or up to 1024
    queries, the chunked online softmax beyond (on the meta device the
    direct version for any call outside training). MLA's route; every
    other attention takes the kernels through ``sdpa``."""
    global plain_attention_calls
    with _count_lock:
        plain_attention_calls += 1
    Sq, Sk = q.shape[1], k.shape[1]
    # the chunked versions bound the memory of the score tiles; a meta
    # tensor has none, and the direct version does the same products and
    # touches the same scores in far fewer ops (the dry-run's count)
    meta = q.device.type == "meta"
    if Sq == 1 and Sk > 8192 and not meta:
        return sdpa_decode_chunked(q, k, v, kv_valid=kv_valid, scale=scale)
    if Sq <= 1024 or (meta and not _trains(q, k, v)):
        return sdpa_reference(q, k, v, causal=causal and Sq > 1,
                              window=window, q_offset=q_offset,
                              kv_valid=kv_valid, scale=scale)
    if _trains(q, k, v):
        from repro_torch.models import flash_ref

        _from_zero(kv_valid, causal, q_offset)
        return flash_ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window, scale=scale,
                                             use_kernel=False)
    return sdpa_chunked(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, scale=scale)


def _trains(q, k, v) -> bool:
    """The attention is differentiated: grad mode on and an input that
    requires grad."""
    return torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)


def _from_zero(kv_valid, causal, q_offset) -> None:
    if kv_valid is not None or (causal and int(q_offset) != 0):
        raise ValueError("a multi-token sdpa runs from position 0 with "
                         "no kv_valid")


def sdpa(q, k, v, *, causal=True, window=None, q_offset=0, kv_valid=None,
         scale=None):
    """Dispatch by shape (``repro/models/layers.py`` ``sdpa`` with
    impl=pallas); the tensor's device picks kernel or plain version inside
    the ops. More than one query is a prefill (or the encoder's and
    cross-attention's full pass) from position 0: the flash kernel, or
    in training ``flash_ref.FlashAttention`` (the module docstring). A
    single token attends to the first ``kv_valid`` slots of a cache: the
    decode kernel."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa

    if q.shape[1] > 1:
        _from_zero(kv_valid, causal, q_offset)
        if _trains(q, k, v):
            from repro_torch.models import flash_ref

            if q.device.type == "cpu" and q.shape[1] <= 1024:
                return sdpa_reference(q, k, v, causal=causal, window=window,
                                      scale=scale)
            return flash_ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window, scale=scale)
        return fa.flash_attention(q, k, v, causal=causal, window=window,
                                  scale=scale)
    if window is not None:
        raise ValueError("a decode's window is its ring buffer's size")
    return da.decode_attention(q, k, v, kv_valid=kv_valid, scale=scale)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def attention_specs(cfg) -> dict:
    d, H, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    dt = cfg.param_dtype
    # heads that do not divide the model axis may shard head_dim instead
    hd = "cache_head_dim" if cfg.attn_head_dim_sharding else "head_dim"
    return {
        "wq": nn.dense((d, H, Dh), (emb, "heads", hd), dt),
        "wk": nn.dense((d, Hkv, Dh), (emb, "kv_heads", hd), dt),
        "wv": nn.dense((d, Hkv, Dh), (emb, "kv_heads", hd), dt),
        "wo": nn.dense((H, Dh, d), ("heads", hd, emb), dt),
    }


def make_attn_cache_specs(cfg, batch: int, max_len: int) -> dict:
    """A sliding-window layer keeps a ring of min(max_len, window) slots;
    the cache is in ``serve_cache_dtype`` (fp8 for llama3-405b and
    llava-next-34b), else the compute dtype."""
    L = min(max_len, cfg.window) if cfg.attn_kind == "swa" else max_len
    dt = cfg.serve_cache_dtype or cfg.compute_dtype
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", None, "kv_heads", "cache_head_dim")
    return {"k": nn.zeros(shape, axes, dt), "v": nn.zeros(shape, axes, dt)}


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).reshape(
        B, S, *w.shape[1:])


def out_project(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, wo) as one matmul."""
    B, S = o.shape[:2]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1]).to(o.dtype)


def write_prefill(cache: dict, new: dict, S: int, ring: bool) -> None:
    """A prefill's S positions into a cache of Lc slots, in place: the last
    Lc of them (slots past S stay zero); a ring buffer (``ring``, S > Lc)
    rolled by S % Lc, so that position t sits in slot t % Lc where the
    decode at position S writes slot S % Lc."""
    for name, t in new.items():
        c = cache[name]
        Lc = c.shape[1]
        t = t[:, -Lc:].to(c.dtype)
        if ring and S > Lc:
            t = torch.roll(t, S % Lc, dims=1)
        c[:, :t.shape[1]] = t


def attention_apply(
    p: dict,
    x: torch.Tensor,               # (B, S, d)
    *,
    cfg,
    positions: torch.Tensor,       # (S,) absolute positions
    cache: dict | None = None,
    cache_index: int | None = None,  # decode: #tokens already in cache
    mode: str,                     # train | prefill | decode
) -> tuple[torch.Tensor, dict | None]:
    """Prefill writes the layer's cache in place; decode writes one slot of
    it in place (slot ``cache_index``, or ``cache_index % Lc`` in a
    sliding-window ring), then attends over the slots written so far
    (``min(cache_index + 1, Lc)``: a ring's slots hold unordered positions,
    which the softmax does not mind; rope is already in the keys). The
    reference returns new arrays instead; the port's caller keeps no other
    reference to the cache it hands in. Train is the prefill with no
    cache."""
    B, S, d = x.shape
    window = cfg.window if cfg.attn_kind == "swa" else None
    q = apply_rope(project(x, p["wq"]), positions, cfg.rope_theta)
    k = apply_rope(project(x, p["wk"]), positions, cfg.rope_theta)
    v = project(x, p["wv"])
    if S > 1:
        # the flash inputs at their natural head placement (the reference's
        # constraint, recorded inside a mesh context)
        q = nn.logical_constraint(q, ("batch", None, "heads", None))
        k = nn.logical_constraint(k, ("batch", None, "kv_heads", None))
        v = nn.logical_constraint(v, ("batch", None, "kv_heads", None))

    if mode == "decode":
        assert cache is not None and S == 1
        Lc = cache["k"].shape[1]
        if cache_index < 0 or (window is None and cache_index >= Lc):
            raise ValueError(f"decode slot {cache_index} outside a cache of {Lc}")
        slot = cache_index % Lc if window is not None else cache_index
        # the slot is written before kv_valid = cache_index + 1 reads it
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
        out = sdpa(q, cache["k"], cache["v"], causal=False,
                   kv_valid=min(cache_index + 1, Lc))
    else:
        if cache is not None:  # prefill writes the cache
            write_prefill(cache, {"k": k, "v": v}, S, window is not None)
        out = sdpa(q, k, v, causal=True, window=window)
    return out_project(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): latent-compressed KV with decoupled RoPE
# ---------------------------------------------------------------------------


def mla_specs(cfg) -> dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    dt = cfg.param_dtype
    dn, dr, dv, r = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    specs = {
        "w_dkv": nn.dense((d, r + dr), (emb, "kv_lora_w"), dt),  # c_kv ++ k_rope
        "kv_norm": rmsnorm_specs(r),
        "w_uk": nn.dense((r, H, dn), ("kv_lora_w", "heads", "head_dim"), dt),
        "w_uv": nn.dense((r, H, dv), ("kv_lora_w", "heads", "head_dim"), dt),
        "wo": nn.dense((H, dv, d), ("heads", "head_dim", emb), dt),
    }
    if m.q_lora_rank:
        specs["w_dq"] = nn.dense((d, m.q_lora_rank), (emb, "q_lora"), dt)
        specs["q_norm"] = rmsnorm_specs(m.q_lora_rank)
        specs["w_uq"] = nn.dense((m.q_lora_rank, H, dn + dr),
                                 ("q_lora", "heads", "head_dim"), dt)
    else:
        specs["wq"] = nn.dense((d, H, dn + dr), (emb, "heads", "head_dim"),
                               dt)
    return specs


def make_mla_cache_specs(cfg, batch: int, max_len: int) -> dict:
    m = cfg.mla
    return {
        "ckv": nn.zeros((batch, max_len, m.kv_lora_rank),
                        ("batch", None, "kv_lora"), cfg.compute_dtype),
        "krope": nn.zeros((batch, max_len, m.qk_rope_head_dim),
                          ("batch", None, None), cfg.compute_dtype),
    }


def mla_apply(
    p: dict,
    x: torch.Tensor,
    *,
    cfg,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_index: int | None = None,
    mode: str,
) -> tuple[torch.Tensor, dict | None]:
    """Prefill attends with expanded keys and values (q/k head dn + dr
    against a v head of dv); decode attends in the latent space (W_uk
    folded into q, W_uv into the output: one latent head of r + dr
    against r), so the cache stays (r + dr) a token. Both through
    ``sdpa_plain``. Caches are written in place; train is the prefill
    with no cache."""
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.num_heads
    dn, dr, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank

    if m.q_lora_rank:
        cq = rmsnorm(p["q_norm"], x @ p["w_dq"].to(x.dtype), cfg.rms_eps)
        q = project(cq, p["w_uq"])
    else:
        q = project(x, p["wq"])
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    dkv = x @ p["w_dkv"].to(x.dtype)
    ckv = rmsnorm(p["kv_norm"], dkv[..., :r], cfg.rms_eps)
    krope = apply_rope(dkv[..., None, r:], positions, cfg.rope_theta)[:, :, 0]

    scale = 1.0 / math.sqrt(dn + dr)
    if mode == "decode":
        assert cache is not None and S == 1
        if not 0 <= cache_index < cache["ckv"].shape[1]:
            raise ValueError(f"decode slot {cache_index} outside a cache of "
                             f"{cache['ckv'].shape[1]}")
        cache["ckv"][:, cache_index] = ckv[:, 0].to(cache["ckv"].dtype)
        cache["krope"][:, cache_index] = krope[:, 0].to(cache["krope"].dtype)
        ckv_all = cache["ckv"].to(x.dtype)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"].to(x.dtype))
        k_lat = torch.cat([ckv_all, cache["krope"].to(x.dtype)],
                          dim=-1)[:, :, None, :]
        q_full = torch.cat([q_lat, q_rope], dim=-1)          # (B,1,H,r+dr)
        ctx = sdpa_plain(q_full, k_lat, ckv_all[:, :, None, :], causal=False,
                         kv_valid=cache_index + 1, scale=scale)
        out = torch.einsum("bshr,rhk->bshk", ctx, p["w_uv"].to(x.dtype))
    else:
        if cache is not None:
            write_prefill(cache, {"ckv": ckv, "krope": krope}, S, False)
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"].to(x.dtype))
        vfull = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"].to(x.dtype))
        kfull = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, dr)],
                          dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = sdpa_plain(qfull, kfull, vfull, causal=True, scale=scale)
    return out_project(out, p["wo"]), cache


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    dt = cfg.param_dtype
    return {
        "wi_gate": nn.dense((d, ff), (emb, "mlp"), dt),
        "wi_up": nn.dense((d, ff), (emb, "mlp"), dt),
        "wo": nn.dense((ff, d), ("mlp", emb), dt),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, row-wise: taken over ``MLP_CHUNK`` tokens at a time so a
    92k-token prefill never holds its (tokens, d_ff) gate and up at once."""
    flat = x.reshape(-1, x.shape[-1])
    wg = p["wi_gate"].to(x.dtype)
    wu = p["wi_up"].to(x.dtype)
    wo = p["wo"].to(x.dtype)
    out = torch.empty_like(flat)
    for i in range(0, flat.shape[0], MLP_CHUNK):
        xc = flat[i:i + MLP_CHUNK]
        h = F.silu((xc @ wg).to(f32)).to(x.dtype) * (xc @ wu)
        out[i:i + MLP_CHUNK] = h @ wo
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# MoE with capacity-based index dispatch (GShard-style)
# ---------------------------------------------------------------------------


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, E = cfg.d_model, m.num_experts
    emb = "embed_fsdp" if cfg.fsdp else "embed"
    dt = cfg.param_dtype
    specs = {
        "router": nn.dense((d, E), ("embed", "experts"), f32),
        "we_gate": nn.dense((E, d, m.d_expert),
                            ("experts", emb, "expert_mlp"), dt),
        "we_up": nn.dense((E, d, m.d_expert), ("experts", emb, "expert_mlp"),
                          dt),
        "we_down": nn.dense((E, m.d_expert, d),
                            ("experts", "expert_mlp", emb), dt),
    }
    if m.num_shared:
        specs["shared"] = mlp_specs(cfg, d_ff=m.d_expert * m.num_shared)
    return specs


def moe_apply(p: dict, x: torch.Tensor, *, cfg) -> tuple[torch.Tensor, dict]:
    """Returns (output, aux), aux the router losses (``moe_lb_loss``,
    ``moe_z_loss``) and the dropped share of (token, expert) assignments.

    The reference's capacity dispatch (``repro/models/layers.py:535-594``):
    a sequence's tokens take capacity C = S k cf / E slots an expert, in
    token order (a masked cumsum); the tokens past C drop (their residual
    path still carries them). Tokens are scattered into (B, E, C, d), each
    expert's SwiGLU runs as one batched product, and each token gathers its
    k slots back, weighted by its renormalised gates."""
    m = cfg.moe
    B, S, d = x.shape
    E, K = m.num_experts, m.top_k
    C = max(1, int(S * K * m.capacity_factor / E))

    logits = x.to(f32) @ p["router"]                         # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)       # (B,S,K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot of each (token, k) within its expert's queue
    flat = F.one_hot(gate_idx, E).reshape(B, S * K, E)       # int64
    pos_in_expert = torch.cumsum(flat, dim=1) - flat
    slot = (pos_in_expert * flat).sum(-1).reshape(B, S, K)
    keep = slot < C
    gate_vals = gate_vals * keep

    # scatter tokens into (B, E, C + 1, d); slot C is the trash for drops
    e_flat = gate_idx.reshape(B, S * K)
    s_flat = torch.where(keep.reshape(B, S * K), slot.reshape(B, S * K), C)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    token_src = x[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    dispatch = torch.zeros((B, E, C + 1, d), dtype=x.dtype, device=x.device)
    dispatch.index_put_((bidx, e_flat, s_flat), token_src, accumulate=True)
    dispatch = dispatch[:, :, :C]                            # (B,E,C,d)

    g = torch.einsum("becd,edf->becf", dispatch, p["we_gate"].to(x.dtype))
    u = torch.einsum("becd,edf->becf", dispatch, p["we_up"].to(x.dtype))
    h = F.silu(g.to(f32)).to(x.dtype) * u
    eout = torch.einsum("becf,efd->becd", h, p["we_down"].to(x.dtype))

    # gather back: a token reads its k slots (a dropped one has zero gate)
    out_tok = eout[bidx, e_flat, s_flat.clamp(max=C - 1)]    # (B,S*K,d)
    out_tok = out_tok.reshape(B, S, K, d) * gate_vals[..., None].to(x.dtype)
    y = out_tok.sum(dim=2)
    if m.num_shared:
        y = y + mlp_apply(p["shared"], x)

    # aux: Switch load balance and the router z-loss
    density = flat.reshape(B, S, K, E).sum(2).to(f32).mean(dim=(0, 1))
    route_frac = probs.mean(dim=(0, 1))
    aux = {"moe_lb_loss": E * torch.sum(density * route_frac),
           "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
           "moe_drop_frac": 1.0 - keep.to(f32).mean()}
    return y, aux
