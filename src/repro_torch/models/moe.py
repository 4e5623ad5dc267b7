"""Mixture-of-Experts FFN: top-k token-choice routing with group-local,
sort-based capacity dispatch.  Counterpart of ``repro.models.moe``.

Dispatch, within each routing group (one a batch row):
  1. float32 router logits -> softmax -> the top k (gates, expert ids) of
     each token, taken by a STABLE descending sort, so ties go to the lower
     expert index as ``jax.lax.top_k`` breaks them (``torch.topk`` promises
     no order on ties);
  2. the T*k assignments sorted by expert id with a stable argsort;
  3. rank within an expert = position - first occurrence (``searchsorted``,
     left side); an assignment with rank >= capacity is dropped to the
     sentinel row ``e * cap``, which is cut off;
  4. tokens scattered into an (E*C, d) buffer, batched expert GEMMs;
  5. gathered back per assignment and combined with the gate weights.

The combine, ``sum(per_assign * gates.astype(bf16), axis=k)`` in the
reference, is a bf16 product summed over k.  XLA computes it inside the
compiled layer body with the products at float32 (``jnp.sum`` upcasts bf16
to float32, and XLA drops the rounding of a bf16 value that is only read
back at float32), sums the k of them in float32 and rounds once.  The port
computes exactly that: float32 products of the bf16 operands, a float32
sum over k, one rounding; on the CPU its output has the reference's bits.

Aux losses (Switch): load balancing and router z, returned for training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import einsum, matmul, silu
from repro_torch.models.params import ParamSpec, dense_spec


def moe_spec(cfg):
    d, dff, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    return {
        "router": dense_spec(d, e, ("embed", None)),
        "wi_gate": ParamSpec((e, d, dff), ("experts", "embed", "expert_mlp"), "normal", d**-0.5),
        "wi_up": ParamSpec((e, d, dff), ("experts", "embed", "expert_mlp"), "normal", d**-0.5),
        "wo": ParamSpec((e, dff, d), ("experts", "expert_mlp", "embed"), "normal", dff**-0.5),
    }


def top_k_stable(probs, k: int):
    """``(values, indices)`` of the k largest along the last axis, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def capacity(t: int, k: int, e: int, capacity_factor: float) -> int:
    """Slots per (group, expert): the reference's expression, exactly."""
    cap = int(max(k, (t * k) // e * capacity_factor)) if e > 0 else 0
    return max(cap, 1)


def dispatch(eidx, e: int, cap: int):
    """Group-local sort-based dispatch of ``eidx (G, T, k)``: ``(dest,
    order)``, each ``(G, T*k)``.  ``order`` sorts the assignments by expert
    (stable), ``dest`` is each sorted assignment's buffer row, ``e * cap``
    for a dropped one."""
    g, t, k = eidx.shape
    flat_e = eidx.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * k, device=eidx.device)[None, :] - first
    dest = torch.where(rank < cap, sorted_e * cap + rank, e * cap)
    return dest, order


def moe(p, x, cfg, *, capacity_factor: float | None = None):
    """x: (B, S, d) -> (y, aux) with aux = {"lb_loss", "z_loss"}.  Routing
    groups: one a batch row (the reference's default ``n_groups``); capacity
    is per (group, expert)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    g, t = b, s

    logits = matmul(x, p["router"]["w"]).float()  # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = top_k_stable(probs, k)  # (G, T, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    # --- aux losses (Switch Transformer) ---
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(eidx, e).float().sum(2).mean(dim=(0, 1))
    lb_loss = e * torch.sum(me * ce / k)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # --- group-local sort-based dispatch ---
    cap = capacity(t, k, e, capacity_factor)
    dest, order = dispatch(eidx, e, cap)
    tok_of = order // k
    gathered_in = torch.gather(x, 1, tok_of[..., None].expand(-1, -1, d))  # (G, T*k, d)
    buf = torch.zeros((g, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), gathered_in)  # dropped ones all land in the cut row
    buf = buf[:, :-1].reshape(g, e, cap, d)

    # --- expert GEMMs ---
    h = silu(einsum("gecd,edf->gecf", buf, p["wi_gate"])) * einsum("gecd,edf->gecf", buf, p["wi_up"])
    out = einsum("gecf,efd->gecd", h, p["wo"]).reshape(g, e * cap, d)
    out = torch.cat([out, out.new_zeros((g, 1, d))], dim=1)

    # --- combine ---
    gathered = torch.gather(out, 1, dest[..., None].expand(-1, -1, d))  # (G, T*k, d)
    inv = torch.argsort(order, dim=1, stable=True)
    per_assign = torch.gather(gathered, 1, inv[..., None].expand(-1, -1, d)).reshape(g, t, k, d)
    y = torch.sum(per_assign.float() * gates.to(x.dtype).float()[..., None], dim=2).to(x.dtype)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
