"""Transformer blocks (pre-norm residual).  Counterpart of
``repro.models.blocks`` for the attention mixers; the Mamba mixer and the
Zamba-style shared block come with the SSM slice (``ROADMAP.md`` A10
slice 1b) and raise ``NotImplementedError`` here."""

from __future__ import annotations

import torch

from repro_torch.models.attention import attention, attn_spec
from repro_torch.models.layers import mlp, mlp_spec, rmsnorm, rmsnorm_spec
from repro_torch.models.moe import moe, moe_spec

SSM_SLICE = "the Mamba2 mixer and the shared block are ported in ROADMAP.md A10 slice 1b"

ZERO_AUX = {"lb_loss": torch.zeros((), dtype=torch.float32), "z_loss": torch.zeros((), dtype=torch.float32)}


def _no_mamba(mixer):
    if mixer == "mamba":
        raise NotImplementedError(SSM_SLICE)


def block_spec(cfg, kind):
    mixer, ff = kind
    _no_mamba(mixer)
    s = {"ln1": rmsnorm_spec(cfg.d_model), "attn": attn_spec(cfg)}
    if ff == "dense":
        s["ln2"] = rmsnorm_spec(cfg.d_model)
        s["mlp"] = mlp_spec(cfg.d_model, cfg.d_ff, cfg.act)
    elif ff == "moe":
        s["ln2"] = rmsnorm_spec(cfg.d_model)
        s["moe"] = moe_spec(cfg)
    return s


def block_cache_spec(cfg, kind, batch: int, seq: int):
    """``{"k": (shape, logical_axes, dtype), "v": ...}`` of one layer's
    decode cache.  Sliding-window layers with ``cfg.windowed_cache`` hold a
    window-sized ring buffer instead of the full sequence."""
    mixer, _ = kind
    _no_mamba(mixer)
    cache_len = seq
    if mixer == "local" and cfg.windowed_cache and cfg.sliding_window:
        cache_len = min(seq, cfg.sliding_window)
    kvshape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "cache_seq", "kv", None)
    return {"k": (kvshape, axes, torch.bfloat16), "v": (kvshape, axes, torch.bfloat16)}


def block_apply(p, x, kind, *, cfg, mode, cache=None, pos=None, positions=None, mrope_positions=None):
    """Returns ``(x, new_cache, aux)``, ``x`` the residual stream's new value
    in float32, unrounded.

    The reference runs a stack's layers inside one compiled ``lax.scan``
    body, where XLA keeps each bf16 residual sum at float32 precision for
    the next norm, which reads it through an explicit ``astype(float32)``,
    while the next residual add reads it rounded to bf16.  So this block
    takes ``x`` as bf16 (a layer stack's carry, rounded) or as float32 (the
    sum of the previous layer in the same step), normalises the unrounded
    value and adds to the rounded one.  The caller rounds the result to
    bf16 where the reference's scan carry does."""
    mixer, ff = kind
    _no_mamba(mixer)
    act = p["ln1"]["scale"].dtype
    aux = ZERO_AUX
    h, new_cache = attention(
        p["attn"],
        rmsnorm(p["ln1"], x, cfg.norm_eps).to(act),
        cfg=cfg,
        mode=mode,
        positions=positions,
        mrope_positions=mrope_positions,
        window=cfg.sliding_window if mixer == "local" else None,
        causal=(mixer != "bidir"),
        use_rope=cfg.use_rope,
        cache=cache,
        pos=pos,
    )
    x = x.to(act).float() + h.float()
    if ff == "dense":
        x = x.to(act).float() + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps).to(act), cfg.act).float()
    elif ff == "moe":
        h, aux = moe(p["moe"], rmsnorm(p["ln2"], x, cfg.norm_eps).to(act), cfg)
        x = x.to(act).float() + h.float()
    return x, new_cache, aux
