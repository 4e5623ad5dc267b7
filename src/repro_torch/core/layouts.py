"""Data layouts and the padding helpers shared by every padded layout
(kernel streams, grid cells, plan data).  Counterpart of
``repro.core.layouts``.

SoA  - three tensors ``x, y, z`` of shape ``(m,)``.
AoaS - one ``(m, 4)`` tensor of aligned structs ``(x, y, z, 0)``: 16 bytes a
       point in float32, 32 in float64, so a kernel loads a point as one
       ``float4`` (two ``double2``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PointSet:
    """A set of m attributed 2-D points in SoA form."""

    x: torch.Tensor  # (m,)
    y: torch.Tensor  # (m,)
    z: torch.Tensor  # (m,)

    @property
    def m(self) -> int:
        return self.x.shape[0]

    def astype(self, dtype) -> "PointSet":
        return PointSet(self.x.to(dtype), self.y.to(dtype), self.z.to(dtype))


def coord_sentinel(dtype, device=None):
    """Large-but-finite padding coordinate ``finfo.max / 4``: its squared
    distance overflows to +inf, so a pad point gets weight ``exp(-a*inf) = 0``
    and never enters a k-best set."""
    return torch.tensor(torch.finfo(dtype).max / 4, dtype=dtype, device=device)


def pad_to(x, mult: int, value):
    """Pad a 1-D tensor to the next multiple of ``mult`` with ``value``."""
    pad = (-x.shape[0]) % mult
    if pad == 0:
        return x
    fill = torch.as_tensor(value, dtype=x.dtype, device=x.device).expand(pad)
    return torch.cat([x, fill])


def pad_tail(x, n_pad: int):
    """Pad a 1-D tensor by repeating its last element.  Used for query blocks
    (a repeated query adds no new candidate cells to a block rectangle)."""
    if n_pad == 0:
        return x
    return torch.cat([x, x[-1:].expand(n_pad)])


def soa_to_aoas(x, y, z=None):
    """Pack SoA tensors into a contiguous ``(m, 4)`` aligned-struct tensor
    ``(x, y, z, 0)``; ``z`` defaults to 0."""
    zeros = torch.zeros_like(x)
    return torch.stack([x, y, zeros if z is None else z, zeros], dim=1).contiguous()


def aoas_to_soa(a):
    """Unpack an ``(m, 4)`` aligned-struct tensor into ``(x, y, z)``."""
    return a[:, 0], a[:, 1], a[:, 2]
