"""Plain versions of the decode kernel: single-token attention against a
(possibly low-precision) cache, the CPU path of ``ops`` and the oracle the
CUDA kernel is held to; and the kernel's split-and-merge arithmetic, which
the tests hold to the reference on the CPU."""

import math

import torch

from repro_torch.models.layers import sdpa_reference

NEG_INF = -1e30


def decode_attention_ref(q, k, v, *, kv_valid=None, scale=None):
    """q (B, 1, H, D); k/v (B, L, Hkv, D); kv_valid None, an int or (B,)."""
    return sdpa_reference(q, k, v, causal=False, kv_valid=kv_valid,
                          scale=scale)


def decode_attention_split_ref(q, k, v, kv_valid, split, *, scale=None):
    """The split-KV kernel's arithmetic in float32: the slots of each
    (sequence, KV head) cut into ranges of ``split``, each range's
    (m, l, acc) over its valid slots (m = NEG_INF, l = 0 where it has
    none), then the merge m = max m_i, l = sum l_i e^(m_i - m),
    o = sum acc_i e^(m_i - m) / max(l, 1e-30). q (B, 1, H, D); k/v
    (B, L, Hkv, D); kv_valid an int or (B,). The main path never calls it."""
    B, _, H, D = q.shape
    L, hkv = k.shape[1], k.shape[2]
    rep = H // hkv
    scale = scale or 1.0 / math.sqrt(D)
    n = -(-L // split)
    pad = n * split - L
    valid = torch.as_tensor(kv_valid).reshape(-1).expand(B)
    live = torch.arange(n * split)[None, :] < valid[:, None].clamp(max=L)
    live = live.reshape(B, 1, 1, n, split)                  # (B,1,1,n,split)

    qf = (q.float() * scale).reshape(B, hkv, rep, D)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = torch.einsum("bhrd,blhd->bhrl", qf, kf).reshape(B, hkv, rep, n, split)
    s = torch.where(live, s, NEG_INF)
    m = s.amax(-1)                                          # (B,hkv,rep,n)
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    vf = torch.where(live.reshape(B, n * split, 1, 1), vf, 0.0)
    acc = torch.einsum("bhrns,bnshd->bhrnd", p,
                       vf.reshape(B, n, split, hkv, D))

    mm = m.amax(-1, keepdim=True)
    w = torch.where(l > 0, torch.exp(m - mm), 0.0)
    o = (acc * w[..., None]).sum(-2) \
        / (l * w).sum(-1).clamp_min(1e-30)[..., None]
    return o.reshape(B, 1, H, D).to(q.dtype)
