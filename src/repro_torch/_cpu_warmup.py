"""A one-time warm-up of PyTorch's CPU transcendentals, run when the
package is imported.

With several intra-op threads, the first ``torch.exp``, ``torch.log`` or
``torch.cos`` over a large CPU tensor in a process can give one thread's
share of the result far off (seen with torch 2.13.0+cpu on 8 threads: one
eighth of 2^22 elements, up to 1.5e7 ulps in float64), while every later
call gives the steady bits, those of a one-thread computation.  Any such
call on a small tensor, which one thread computes alone, ends it for the
whole process; the port's plain kernel versions (``kernels/_common.py:
pow_weight``) and the alpha chain (``core/aidw.py``) run on the CPU, so the
port makes that call before anything of it runs.  It touches no CUDA
tensor and changes no result beyond removing the fault
(``tests/test_torch_core.py::test_first_cpu_exp_log_give_steady_bits``).
"""

from __future__ import annotations

import torch

# below the intra-op grain size (32,768 elements): the calling thread
# computes each call alone
_WARM_ELEMS = 1024


def warm_cpu_transcendentals() -> None:
    """One small call of each transcendental the port's CPU path uses, in
    float32 and float64."""
    for dtype in (torch.float32, torch.float64):
        x = torch.linspace(0.5, 2.0, _WARM_ELEMS, dtype=dtype)
        torch.exp(x)
        torch.log(x)
        torch.cos(x)
