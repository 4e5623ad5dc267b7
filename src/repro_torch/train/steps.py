"""Serving step functions: prefill and decode.  Counterpart of
``repro.train.steps``' ``make_prefill_step``, ``make_serve_step`` and
``pad_caches``."""

from __future__ import annotations

import torch

from repro_torch.models.params import tree_map


def make_prefill_step(model, cfg):
    """``prefill_step(params, batch) -> (last_logits (B, V) f32, caches)``."""

    def prefill_step(params, batch):
        h, caches, _ = model.apply(params, batch["tokens"], mode="prefill", extra=batch)
        return model.logits(params, h[:, -1:, :])[:, 0], caches

    return prefill_step


def make_serve_step(model, cfg):
    """``serve_step(params, caches, tokens (B, 1), pos) -> (next_token (B, 1)
    int32, logits (B, V) f32, caches)``; the caches are updated in place.
    The greedy token is the first index of the maximum, as ``jnp.argmax``
    picks it."""

    def serve_step(params, caches, tokens, pos):
        h, new_caches, _ = model.apply(params, tokens, mode="decode", caches=caches, pos=pos)
        logits = model.logits(params, h)[:, 0]
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], logits, new_caches

    return serve_step


def pad_caches(caches, target_seq: int):
    """Grow prefill caches to decode capacity along the cache_seq axis: KV
    leaves ("k", "v", not under "cross") are (layers, B, S, kv, hd) and get
    zeros on axis 2; other leaves pass through."""

    def pad(names, t):
        if names and names[-1] in ("k", "v") and "cross" not in names:
            shape = list(t.shape)
            shape[2] = target_seq - t.shape[2]
            return torch.cat([t, t.new_zeros(shape)], dim=2)
        return t

    return tree_map(pad, caches, with_path=True)
