"""The decoder-only LM (dense, MoE and VLM archs).  Counterpart of
``repro.models.lm``'s ``DecoderLM``; ``EncDecLM`` and the SSM / hybrid
stacks come with ``ROADMAP.md`` A10 slice 1b.

Layers are organised as stacks (``GroupDef``): each parameter leaf of a
stack carries a leading "layers" axis, and the forward pass is a plain
Python loop over it, taking each layer's leaves as views.

``apply`` returns the final *hidden states*; logits are the step
functions' business, so the (B, S, V) float32 tensor never exists in
decode.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, GroupDef
from repro_torch.models import params as pm
from repro_torch.models.blocks import SSM_SLICE, ZERO_AUX, block_apply, block_cache_spec, block_spec
from repro_torch.models.layers import embed, matmul, rmsnorm, rmsnorm_spec


def cast_params(p):
    """Float leaves in the compute dtype, bf16.  On the CPU the tests hand the
    reference's float32 weights in and this casts them, as the reference's
    ``cast_params`` does; on the card the weights may be held in bf16 from
    the start, and the cast, idempotent, returns the same tensors (and the
    same numbers)."""
    return pm.tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, p)


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def _group_spec(cfg, gdef: GroupDef):
    return {f"l{i}": block_spec(cfg, kind) for i, kind in enumerate(gdef.pattern)}


def _stack_leaves(tree, n):
    """(shape, axes, dtype) leaves -> stacked with a leading layers dim."""
    return pm.tree_map(lambda leaf: ((n,) + leaf[0], ("layers",) + leaf[1], leaf[2]), tree)


class DecoderLM:
    """Decoder-only LM over ``cfg.groups``, with the VLM patch-embedding
    merge and M-RoPE."""

    def __init__(self, cfg: ArchConfig):
        if cfg.shared_block:
            raise NotImplementedError(SSM_SLICE)
        self.cfg = cfg

    # ---------------------------------------------------------------- specs
    def spec(self):
        cfg = self.cfg
        s = {
            "embed": {"table": pm.ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal", 0.02)},
            "ln_f": rmsnorm_spec(cfg.d_model),
            "stacks": {f"g{i}": pm.stack(_group_spec(cfg, g), g.repeats) for i, g in enumerate(cfg.groups)},
        }
        if not cfg.tie_embeddings:
            s["unembed"] = {"w": pm.ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "normal",
                                              cfg.d_model**-0.5)}
        return s

    def cache_spec(self, batch: int, seq: int):
        """``(shape, logical_axes, dtype)`` leaves of the decode caches."""
        cfg = self.cfg
        return {
            f"g{i}": _stack_leaves({f"l{j}": block_cache_spec(cfg, kind, batch, seq)
                                    for j, kind in enumerate(g.pattern)}, g.repeats)
            for i, g in enumerate(cfg.groups)
        }

    # -------------------------------------------------------------- forward
    def _embed_inputs(self, p, tokens, extra, mode):
        cfg = self.cfg
        x = embed(p["embed"], tokens)
        if cfg.n_vis_tokens and extra is not None and "visual_embeds" in extra and mode != "decode":
            vis = torch.as_tensor(extra["visual_embeds"], device=x.device).to(x.dtype)  # (B, n_vis, d) stub
            x = torch.cat([vis, x[:, cfg.n_vis_tokens:, :]], dim=1)
        return x

    def _positions(self, tokens, mode, pos, extra):
        cfg = self.cfg
        b, s = tokens.shape
        if mode == "decode":
            positions = pos.to(torch.int32).expand(b, s)
            mrope = pos.to(torch.int32).expand(3, b, s) if cfg.mrope_sections else None
        else:
            positions = torch.arange(s, dtype=torch.int32, device=tokens.device)[None].expand(b, s)
            mrope = None
            if cfg.mrope_sections:
                if extra is not None and "mrope_positions" in extra:
                    mrope = torch.as_tensor(extra["mrope_positions"], device=tokens.device)
                else:
                    mrope = positions[None].expand(3, b, s)
        return positions, mrope

    def apply(self, p, tokens, *, mode: str = "train", caches=None, pos=None, extra=None):
        """tokens (B, S) int -> ``(hidden (B, S, d) bf16, new_caches, aux)``.

        ``mode`` is "train", "prefill" (returns each stack's K/V caches,
        (layers, B, S, KV, hd) bf16) or "decode" (``pos``, a Python int or a
        0-d tensor, is the position of the one new token; ``caches`` is
        updated in place and returned)."""
        cfg = self.cfg
        p = cast_params(p)
        if mode == "decode":
            pos = torch.as_tensor(pos, device=tokens.device)  # once, not once a layer
        x = self._embed_inputs(p, tokens, extra, mode).to(torch.bfloat16)
        positions, mrope = self._positions(tokens, mode, pos, extra)
        aux = ZERO_AUX
        new_caches = {}

        for gi, gdef in enumerate(cfg.groups):
            gname = f"g{gi}"
            stack_params = p["stacks"][gname]
            stack_caches = caches[gname] if caches is not None else None
            outs = []
            for j in range(gdef.repeats):
                gp = pm.tree_map(lambda t: t[j], stack_params)  # views of layer j
                gc = pm.tree_map(lambda t: t[j], stack_caches) if stack_caches is not None else {}
                newc = {}
                for i, kind in enumerate(gdef.pattern):
                    x, c, a = block_apply(gp[f"l{i}"], x, kind, cfg=cfg, mode=mode, cache=gc.get(f"l{i}"), pos=pos,
                                          positions=positions, mrope_positions=mrope)
                    if c is not None:
                        newc[f"l{i}"] = c
                    aux = _add_aux(aux, a)
                x = x.to(torch.bfloat16)  # the reference's scan carry
                outs.append(newc)
            if mode == "decode" and stack_caches is not None:
                new_caches[gname] = stack_caches  # written in place, layer by layer
            elif outs[0]:
                new_caches[gname] = pm.tree_map(lambda *ts: torch.stack(ts), *outs)

        x = rmsnorm(p["ln_f"], x, cfg.norm_eps)
        return x, (new_caches if new_caches else None), aux

    def logits(self, p, hidden):
        """float32 logits of ``hidden`` (..., d)."""
        if self.cfg.tie_embeddings:
            w = p["embed"]["table"].T.to(hidden.dtype)
        else:
            w = p["unembed"]["w"].to(hidden.dtype)
        return matmul(hidden, w).float()
