"""Input stand-ins and placements for every (arch x shape) cell, as
``repro/launch/specs.py``.

The stand-ins are tensors on the ``meta`` device: shapes and dtypes, no
memory (the counterpart of the reference's ``ShapeDtypeStruct``s). The
modality frontends are stubs: a VLM cell takes projector patch
embeddings, an audio cell encoder frame embeddings. The placements are
``models/nn.py`` ``Placement``s on a named-axis mesh (``launch/mesh.py``
``Mesh``).
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import data_axes
from repro_torch.models import nn
from repro_torch.models.steps import cache_specs, make_train_state, model_specs

i32 = torch.int32
bf16 = torch.bfloat16
f32 = torch.float32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def train_batch_specs(cfg, shape) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.encdec:
        dec = max(1, int(S * (cfg.audio.dec_len_ratio if cfg.audio else 1.0)))
        return {"frames": _meta((B, S, cfg.d_model), bf16),
                "tokens": _meta((B, dec), i32),
                "labels": _meta((B, dec), i32)}
    if cfg.vlm is not None:
        ptk = cfg.vlm.num_patch_tokens
        return {"patch_embeds": _meta((B, ptk, cfg.d_model), bf16),
                "tokens": _meta((B, S - ptk), i32),
                "labels": _meta((B, S - ptk), i32)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def prefill_input_specs(cfg, shape) -> dict:
    b = train_batch_specs(cfg, shape)
    b.pop("labels")
    return b


def decode_input_specs(cfg, shape) -> dict:
    """(cache, tokens, cache_index) stand-ins for one-new-token serving."""
    B, S = shape.global_batch, shape.seq_len
    cs = cache_specs(cfg, B, S, enc_len=S if cfg.encdec else 0)
    return {"cache": nn.abstract_params(cs),
            "tokens": _meta((B, 1), i32),
            "cache_index": _meta((), i32)}


def state_specs(cfg) -> dict:
    return make_train_state(cfg, abstract=True)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------


def batch_pspec(mesh):
    axes = data_axes(mesh)
    return axes if len(axes) > 1 else axes[0]


def batch_shardings(tree, mesh):
    """Dim 0 (the global batch) of every leaf over the data axes, with the
    divisibility fallback (a batch of 1 is replicated)."""
    dp = 1
    for a in data_axes(mesh):
        dp *= mesh.shape[a]

    def one(x):
        nd = len(x.shape)
        if nd == 0 or x.shape[0] % dp:
            return nn.Placement(mesh, ())
        return nn.Placement(mesh, (batch_pspec(mesh),) + (None,) * (nd - 1))

    return nn.tree_map(one, tree)


def _axes(s: nn.ParamSpec) -> tuple:
    return s.axes or (None,) * len(s.shape)


def _vr_spec(s: nn.ParamSpec) -> nn.ParamSpec:
    if len(s.shape) >= 2:
        return nn.ParamSpec(s.shape[:-1], f32, _axes(s)[:-1])
    return nn.ParamSpec(s.shape, f32, _axes(s))


def _vc_spec(s: nn.ParamSpec) -> nn.ParamSpec:
    if len(s.shape) >= 2:
        return nn.ParamSpec((*s.shape[:-2], s.shape[-1]), f32,
                            (*_axes(s)[:-2], _axes(s)[-1]))
    return nn.ParamSpec((0,), f32, (None,))


def state_specs_tree(cfg) -> dict:
    """The train state's ``ParamSpec``s, in the layout of
    ``make_train_state``: params and AdamW's m and v (or Adafactor's
    momentum) a leaf a layer; Adafactor's row and column statistics on the
    reference's stacked leaves (``nn.stacked_specs``), as
    ``repro/launch/specs.py:94-121`` specs them; the step a 0-d int32."""
    ms = model_specs(cfg)

    def like(dtype):
        return nn.tree_map(
            lambda s: nn.ParamSpec(s.shape, dtype, s.axes), ms)

    step = nn.ParamSpec((), i32)
    if cfg.optimizer == "adafactor":
        grouped = nn.stacked_specs(ms, cfg)
        opt = {"m": like(cfg.optstate_dtype),
               "vr": nn.tree_map(_vr_spec, grouped),
               "vc": nn.tree_map(_vc_spec, grouped), "step": step}
    else:
        opt = {"m": like(cfg.optstate_dtype), "v": like(cfg.optstate_dtype),
               "step": step}
    return {"params": ms, "opt": opt}


def state_shardings(cfg, mesh):
    return nn.param_shardings(state_specs_tree(cfg), mesh)


def cache_shardings(cfg, mesh, batch: int, max_len: int):
    cs = cache_specs(cfg, batch, max_len, enc_len=max_len if cfg.encdec else 0)
    return nn.param_shardings(cs, mesh)
