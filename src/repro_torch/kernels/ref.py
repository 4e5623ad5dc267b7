"""Memory-naive oracles for the kernels, over the full ``(n, m)`` distance
matrix.  Counterpart of ``repro.kernels.ref``."""

from __future__ import annotations

from repro_torch.core.aidw import AIDWParams, aidw_reference
from repro_torch.core.idw import idw_reference
from repro_torch.core.layouts import aoas_to_soa


def aidw_ref(dx, dy, dz, qx, qy, params: AIDWParams, area: float):
    """Oracle of the SoA AIDW kernels.  Returns ``(z_hat, alpha)``."""
    return aidw_reference(dx, dy, dz, qx, qy, params, area=area)


def aidw_ref_aoas(data_aoas, qx, qy, params: AIDWParams, area: float):
    """Oracle of the AoaS kernels: the struct columns through the SoA oracle
    (the layout does not change the maths)."""
    dx, dy, dz = aoas_to_soa(data_aoas)
    return aidw_reference(dx, dy, dz, qx, qy, params, area=area)


def idw_ref(dx, dy, dz, qx, qy, alpha: float):
    """Oracle of the IDW kernel.  Returns z_hat."""
    return idw_reference(dx, dy, dz, qx, qy, alpha)
