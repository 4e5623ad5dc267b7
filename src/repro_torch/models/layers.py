"""Common layers as spec builders and apply functions on tensors.
Counterpart of ``repro.models.layers``.

Every apply takes plain tensor trees made from the matching spec; the
compute dtype is whatever the caller cast the parameters and activations to
(bf16 in the steps).  Norms are computed in float32 and cast back, as the
reference computes them.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.params import ParamSpec, dense_spec


# --------------------------------------------------------------------- norms
def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), (None,), "ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].float()).to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": ParamSpec((d,), (None,), "ones"), "bias": ParamSpec((d,), (None,), "zeros")}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ------------------------------------------------------------------ products
# A product of bf16 operands accumulates in float32 and rounds once to bf16,
# on the card (cuBLAS) as in the reference (XLA on the CPU upcasts the
# operands and runs a float32 GEMM).  torch's own bf16 GEMM on the CPU sums
# in another order, so there the port also upcasts: its products then have
# the reference's bits, which the CPU tests hold.
def einsum(eq: str, *ops):
    """``torch.einsum`` in the operands' dtype, as described above."""
    if ops[0].device.type == "cpu" and ops[0].dtype == torch.bfloat16:
        return torch.einsum(eq, *(o.float() for o in ops)).to(torch.bfloat16)
    return torch.einsum(eq, *ops)


def matmul(a, b):
    """``a @ b`` in the operands' dtype, as described above."""
    if a.device.type == "cpu" and a.dtype == torch.bfloat16:
        return (a.float() @ b.float()).to(torch.bfloat16)
    return a @ b


# -------------------------------------------------------------------- dense
def dense(p, x):
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- embeddings
def embed(p, ids):
    return p["table"][ids]


def unembed(p, x):
    """Tied unembedding: logits in float32."""
    return matmul(x, p["table"].T.to(x.dtype)).float()


def sinusoidal_positions(seq_len: int, d: int, dtype=torch.float32, offset=0, device=None):
    # offset may be a 0-d tensor (decode position)
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device) + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# --------------------------------------------------------------------- RoPE
def _inv_freqs(half: int, theta: float, device):
    """``theta ** (-arange(half) / half)`` in float32: the exponents in
    float32, the power correctly rounded (taken in float64), which gives the
    reference's bits where ``torch.pow`` in float32 is an ulp off."""
    e = -torch.arange(half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float64, device=device), e.double()).float()


def _rotate(x, ang):
    """Rotate the two halves of ``x`` by ``ang (B, S, half)``: the angles'
    cos and sin are cast to the activation dtype first."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, S, H, hd); positions: (B, S)."""
    freqs = _inv_freqs(x.shape[-1] // 2, theta, x.device)
    return _rotate(x, positions.float()[..., None] * freqs)


def apply_mrope(x, positions, sections, theta: float = 10000.0):
    """M-RoPE (Qwen2-VL): positions (3, B, S) for the (t, h, w) streams; the
    rotary half-dim is split into ``sections`` (summing to head_dim // 2),
    each section driven by its own position stream."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {tuple(sections)} do not sum to head_dim // 2 = {half}")
    freqs = _inv_freqs(half, theta, x.device)
    parts, start = [], 0
    for i, sec in enumerate(sections):
        parts.append(positions[i].float()[..., None] * freqs[start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


# ---------------------------------------------------------------- activations
# Written op by op as ``jax.nn`` defines them, so that in bf16 every op
# rounds where the reference's does (XLA rounds each op of a bf16 chain;
# ``F.silu`` and ``F.gelu`` round once, which moves about a third of the
# outputs by one bf16 ulp).
def silu(x):
    """``x * sigmoid(x)``, the sigmoid as ``1 / (1 + exp(-x))``."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x):
    """The tanh approximation of GELU, with its constants in ``x``'s dtype."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


# ----------------------------------------------------------------- MLP / GLU
def mlp_spec(d: int, d_ff: int, act: str = "swiglu"):
    if act in ("swiglu", "geglu"):
        return {
            "wi_gate": dense_spec(d, d_ff, ("embed", "mlp")),
            "wi_up": dense_spec(d, d_ff, ("embed", "mlp")),
            "wo": dense_spec(d_ff, d, ("mlp", "embed")),
        }
    return {
        "wi": dense_spec(d, d_ff, ("embed", "mlp")),
        "wo": dense_spec(d_ff, d, ("mlp", "embed")),
    }


def mlp(p, x, act: str = "swiglu"):
    if act == "swiglu":
        h = silu(dense(p["wi_gate"], x)) * dense(p["wi_up"], x)
    elif act == "geglu":
        h = gelu_tanh(dense(p["wi_gate"], x)) * dense(p["wi_up"], x)
    else:
        h = gelu_tanh(dense(p["wi"], x))
    return dense(p["wo"], h)
