"""The whole slice of the port on the CPU: ``build_plan`` + ``execute`` for
``grid`` (pipelines "prefetch" and "dense") and ``tiled`` against the JAX
package's ``execute`` on the same inputs, and against the committed golden
fixture; and a JAX plan carried across with ``plan_from_reference``.

Tolerances: alpha within 1e-6 absolute and z within 1e-5 relative in
float32; 1e-12 in float64, with the float64 JAX reference made under
JAX's x64 context (``test_torch_core.enable_x64``).  The golden gate is the one of
``tests/test_golden.py``: RTOL 5e-4 / ATOL 5e-5.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aidw import AIDWParams as JParams
from repro.engine import build_plan as j_build_plan
from repro.engine import execute as j_execute
from repro_torch.core.aidw import AIDWParams
from repro_torch.engine import build_plan, execute, plan_from_reference
from test_torch_core import enable_x64

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "aidw_golden.npz")
RTOL, ATOL = 5e-4, 5e-5
TOL = {np.float32: (1e-6, 1e-5), np.float64: (1e-12, 1e-12)}
CONFIGS = [("grid", "prefetch"), ("grid", "dense"), ("tiled", "prefetch")]


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as blob:
        return {k: blob[k] for k in blob.files}


def _batch(golden, name, dtype=np.float32):
    return [golden[f"{name}_{n}"].astype(dtype) for n in ("dx", "dy", "dz", "qx", "qy")]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("impl,pipeline", CONFIGS)
def test_slice_matches_jax_execute(golden, impl, pipeline, dtype):
    atol, rtol = TOL[dtype]
    k, area = int(golden["k"]), float(golden["area"])
    dx, dy, dz, qx, qy = _batch(golden, "clustered", dtype)
    kw = dict(area=area, impl=impl, pipeline=pipeline, block_q=64, block_d=128)
    with enable_x64(dtype == np.float64):
        jp = j_build_plan(dx, dy, dz, params=JParams(k=k, area=area), **kw)
        jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
        jz, ja = np.asarray(jz), np.asarray(ja)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), device="cpu", **kw)
    z, a = execute(plan, qx, qy)
    assert z.dtype == a.dtype == plan.dtype and z.shape == (qx.shape[0],)
    np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=atol)
    np.testing.assert_allclose(z.numpy(), jz, rtol=rtol, atol=0)


@pytest.mark.parametrize("batch", ["uniform", "clustered"])
@pytest.mark.parametrize("impl,pipeline", CONFIGS)
def test_slice_reproduces_golden(golden, impl, pipeline, batch):
    k, area = int(golden["k"]), float(golden["area"])
    dx, dy, dz, qx, qy = _batch(golden, batch)
    plan = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), area=area, impl=impl,
                      pipeline=pipeline, block_q=64, block_d=128, device="cpu")
    z, a = execute(plan, qx, qy)
    np.testing.assert_allclose(a.numpy(), golden[f"{batch}_alpha"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{impl} alpha drift")
    np.testing.assert_allclose(z.numpy(), golden[f"{batch}_z"], rtol=RTOL, atol=ATOL,
                               err_msg=f"{impl} z drift")


def test_grid_pipelines_bitwise_equal_and_deterministic(golden):
    """The tile-skipping pipeline merges exactly the candidates the dense walk
    merges, so both give the same bits; a second run gives them again."""
    k, area = int(golden["k"]), float(golden["area"])
    dx, dy, dz, qx, qy = _batch(golden, "uniform")
    out = {}
    for pipeline in ("prefetch", "dense"):
        plan = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), area=area, impl="grid",
                          pipeline=pipeline, block_q=64, block_d=128, device="cpu")
        out[pipeline] = execute(plan, qx, qy)
    again = execute(plan, qx, qy)
    for x, y, w in zip(out["prefetch"], out["dense"], again):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
        np.testing.assert_array_equal(y.numpy(), w.numpy())


def export_plan(jp):
    """A JAX plan's statics and arrays as plain Python and numpy."""
    p = jp.params
    statics = dict(impl=jp.impl, m=jp.m, area=jp.area, block_q=jp.block_q, block_d=jp.block_d,
                   cand_capacity=jp.cand_capacity, cand_block_d=jp.cand_block_d,
                   seam_level=jp.seam_level, pipeline=jp.pipeline, grid_rebuilds=jp.grid_rebuilds,
                   params=dict(k=p.k, alpha_levels=tuple(p.alpha_levels), r_min=p.r_min,
                               r_max=p.r_max, area=p.area, exact_hit_eps=p.exact_hit_eps))
    arrays = {n: np.asarray(a) for n, a in zip(("dx", "dy", "dz"), jp.data)}
    if jp.grid is not None:
        for n in ("origin", "cell_size", "counts", "cum", "starts", "pt_x", "pt_y", "pt_z"):
            arrays[n] = np.asarray(getattr(jp.grid, n))
        arrays["r_need"] = np.asarray(jp.r_need)
    return statics, arrays


@pytest.mark.parametrize("impl", ["grid", "tiled"])
def test_plan_from_reference_executes_like_jax(golden, impl):
    """The JAX plan's exported state, carried into the port, is the port's own
    plan of the same data, and executes like the JAX plan."""
    atol, rtol = TOL[np.float32]
    k, area = int(golden["k"]), float(golden["area"])
    dx, dy, dz, qx, qy = _batch(golden, "uniform")
    kw = dict(area=area, impl=impl, block_q=64, block_d=128)
    jp = j_build_plan(dx, dy, dz, params=JParams(k=k, area=area), **kw)
    carried = plan_from_reference(*export_plan(jp), device="cpu")
    own = build_plan(dx, dy, dz, params=AIDWParams(k=k, area=area), device="cpu", **kw)
    def leaves(obj):  # every field, tensors and statics, flattened
        if dataclasses.is_dataclass(obj) and not isinstance(obj, AIDWParams):
            return [x for f in dataclasses.fields(obj) for x in leaves(getattr(obj, f.name))]
        return [x for v in obj for x in leaves(v)] if isinstance(obj, tuple) else [obj]

    for a, b in zip(leaves(carried), leaves(own), strict=True):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    jz, ja = j_execute(jp, jnp.asarray(qx), jnp.asarray(qy))
    z, a = execute(carried, qx, qy)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=atol)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=rtol, atol=0)
