"""GQA attention with sliding window, cross-attention, RoPE / M-RoPE and a
(train | prefill | decode) cache protocol.  Counterpart of
``repro.models.attention``.

Attention is plain tensor code, as the reference's is: the score and value
products in the activation dtype, the scores cast to float32, scaled, masked
with ``NEG_INF`` and softmaxed in float32, the weights cast back.  No
library attention kernel stands in for it: its rounding differs from the
reference's.

Cache layout: ``{"k": (B, S_max, KV, hd), "v": ...}`` in bf16.  Decode
writes the new token's K/V into the cache IN PLACE at slot ``pos`` (or
``pos % S_max`` for a ring buffer) and attends over the whole cache under
an iota mask.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_mrope, apply_rope, dense, einsum
from repro_torch.models.params import dense_spec

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attn_spec(cfg):
    d, nh, hd, nkv = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads
    return {
        "wq": dense_spec(d, nh * hd, ("embed", "heads"), bias=cfg.qkv_bias),
        "wk": dense_spec(d, nkv * hd, ("embed", "kv"), bias=cfg.qkv_bias),
        "wv": dense_spec(d, nkv * hd, ("embed", "kv"), bias=cfg.qkv_bias),
        "wo": dense_spec(nh * hd, d, ("heads", "embed")),
    }


def _split_heads(x, n):
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _attend(q, k, v, mask):
    """q (B,S,Hq,hd), k/v (B,T,KV,hd), mask broadcastable to (B,KV,G,S,T).
    Softmax in float32."""
    b, s, hq, hd = q.shape
    kv = k.shape[2]
    g = hq // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores * (1.0 / math.sqrt(hd))
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(b, s, hq * hd)


def _causal_mask(s, t, window, device):
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m[None, None, None]  # (1,1,1,S,T)


def _decode_mask(t, pos, window, device):
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= pos
    if window is not None:
        m = m & (kpos > pos - window)
    return m[None, None, None]  # (1,1,1,1,T)


def cache_write_slot(pos, t: int, ring: bool):
    """The cache slot decode writes at, as a 1-element int64 tensor on
    ``pos``'s device: ``pos % t`` on a ring buffer, else ``pos``, clamped to
    ``[0, t - 1]`` as ``dynamic_update_slice`` clamps its start index."""
    slot = torch.as_tensor(pos, dtype=torch.int64).reshape(1)
    if ring:
        slot = torch.remainder(slot, t)
    return slot.clamp(0, t - 1)


def attention(
    p,
    x,
    *,
    cfg,
    mode: str,
    positions=None,
    mrope_positions=None,
    window: int | None = None,
    causal: bool = True,
    use_rope: bool = True,
    cache=None,
    pos=None,
    kv_x=None,
    static_kv: bool = False,
):
    """Returns ``(out, new_cache)``; ``new_cache`` is None in train mode.

    ``kv_x``: source of K/V for cross-attention (encoder output).  In decode
    mode with ``kv_x=None`` the cache is read and updated in place (the
    returned cache holds the same tensors); cross caches are read-only:
    pass ``static_kv=True``.  ``pos`` is a Python int or a 0-d tensor.
    """
    b, s, _ = x.shape
    q = _split_heads(dense(p["wq"], x), cfg.n_heads)
    hd = q.shape[-1]

    if static_kv:  # cross-attention decode against a frozen cache
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
        mask = torch.ones((1, 1, 1, s, k.shape[1]), dtype=torch.bool, device=x.device)
        return dense(p["wo"], _attend(q, k, v, mask)), cache

    src = kv_x if kv_x is not None else x
    kv_heads = p["wk"]["w"].shape[1] // hd
    k = _split_heads(dense(p["wk"], src), kv_heads)
    v = _split_heads(dense(p["wv"], src), kv_heads)

    if use_rope and kv_x is None:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "decode" and cache is not None:
        # A cache no longer than the window is a RING BUFFER (windowed local
        # layers): slot pos % t holds exactly the last t positions; attention
        # is permutation-invariant over keys, so slot order never matters.
        t = cache["k"].shape[1]
        ring = window is not None and t <= window
        slot = cache_write_slot(pos, t, ring).to(x.device)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        pos_t = torch.as_tensor(pos, device=x.device)
        # ring buffer: every resident slot is in the window; mask only the
        # slots not yet written (all true once pos >= t)
        mask = _decode_mask(t, pos_t, None if ring else window, x.device)
        o = _attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype), mask)
        return dense(p["wo"], o), cache

    # train / prefill (full sequence)
    t = k.shape[1]
    if kv_x is not None or not causal:
        mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=x.device)
    else:
        mask = _causal_mask(s, t, window, x.device)
    out = dense(p["wo"], _attend(q, k, v, mask))
    new_cache = None
    if mode == "prefill":
        new_cache = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    return out, new_cache

