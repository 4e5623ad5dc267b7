"""The MoE layer and the MoE archs (mixtral-8x7b, qwen3-moe-30b-a3b) of the
port's LM scaffold held against the JAX package's on this CPU, at
``smoke(cfg)`` widths, and twins of ``tests/models/test_moe.py``.

The layer, in bf16 as the model runs it, on the reference's weights:
outputs bitwise (the port computes the gated sum over k as XLA does,
``repro_torch.models.moe``), ``lb_loss`` and ``z_loss`` within 4 float32
ulps, and the kept assignments equal, at capacity factor 8 (dropless) and
1.0 (with drops).  Router weights built to tie give tied probabilities: the
top k go to the lower expert index, as ``jax.lax.top_k`` picks them.  The
twins keep the reference test's float32 tolerances (rtol 5e-4, atol 5e-5
against the dense all-experts reference), at fixed seeds in place of
hypothesis.  The archs: ``tests/torch_lm_common.py``'s BOUND.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as j_moe
from repro.models import params as j_pm
from repro.models.lm import cast_params as j_cast
from repro_torch.models import build_model
from repro_torch.models.layers import matmul
from repro_torch.models import moe as t_moe
from repro_torch.models import params as pm
from repro_torch.models.lm import cast_params
from torch_lm_common import (
    BOUND,
    CONTROL_FACTOR,
    MOE,
    configs,
    extras,
    greedy_agrees,
    inputs,
    models,
    port_train_logits,
    rel_err,
    serve_chain,
    slice_run,
    swapped_layers,
    to_np,
)

F32_ULP = float(np.finfo(np.float32).eps)


def _layer(name, cf, seed=0):
    jcfg, cfg = configs(name, moe_capacity_factor=cf)
    jp = jax.device_get(j_pm.materialize(j_moe.moe_spec(jcfg), jax.random.PRNGKey(seed)))
    return jcfg, cfg, jp, pm.from_reference(jp, t_moe.moe_spec(cfg), device="cpu")


def _x(seed, shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return a


def _j_dispatch(eidx, e, cap):
    """The reference's dispatch lines (``repro/models/moe.py``), on its
    top-k expert ids."""
    g, t, k = eidx.shape
    flat_e = eidx.reshape(g, t * k)
    order = jnp.argsort(flat_e, axis=1)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    first = jax.vmap(lambda se: jnp.searchsorted(se, se, side="left"))(sorted_e)
    rank = jnp.arange(t * k)[None, :] - first
    return jnp.where(rank < cap, sorted_e * cap + rank, e * cap), order


def _hold_layer(jcfg, cfg, jp, tp, x):
    jy, jaux = jax.jit(lambda p, x_: j_moe.moe(j_cast(p), x_, jcfg))(jp, jnp.asarray(x).astype(jnp.bfloat16))
    ty, taux = t_moe.moe(cast_params(tp), torch.tensor(x).bfloat16(), cfg)
    assert ty.dtype == torch.bfloat16 and ty.shape == x.shape
    assert np.array_equal(to_np(ty), to_np(jy))
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=4 * F32_ULP)
    return ty


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("name", MOE)
def test_moe_matches_reference(name, cf):
    jcfg, cfg, jp, tp = _layer(name, cf)
    x = _x(1, (2, 24, cfg.d_model))
    _hold_layer(jcfg, cfg, jp, tp, x)
    # the kept assignments: the same top-k ids, the same buffer rows
    tx = cast_params(tp)
    logits = matmul(torch.tensor(x).bfloat16().reshape(2, 24, -1), tx["router"]["w"]).float()  # as the layer
    probs = torch.softmax(logits, -1)
    jg, je = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe_top_k)
    tg, te = t_moe.top_k_stable(probs, cfg.moe_top_k)
    assert np.array_equal(te.numpy(), np.asarray(je)) and np.array_equal(tg.numpy(), np.asarray(jg))
    cap = t_moe.capacity(24, cfg.moe_top_k, cfg.n_experts, cf)
    assert cap == int(max(cfg.moe_top_k, (24 * cfg.moe_top_k) // cfg.n_experts * cf))
    jdest, jorder = _j_dispatch(je, cfg.n_experts, cap)
    dest, order = t_moe.dispatch(te, cfg.n_experts, cap)
    assert np.array_equal(dest.numpy(), np.asarray(jdest)) and np.array_equal(order.numpy(), np.asarray(jorder))
    dropped = int((dest == cfg.n_experts * cap).sum())
    assert (dropped == 0) == (cf == 8.0)  # dropless at 8, drops at 1.0


@pytest.mark.parametrize("name", MOE)
def test_moe_ties_go_to_the_lower_expert(name):
    """Router columns built to tie (expert 2i + 1 a copy of expert 2i):
    every token's probabilities tie in pairs, and the top k take the lower
    index of a pair first, as the reference does."""
    jcfg, cfg, jp, tp = _layer(name, 8.0, seed=3)
    w = np.array(jp["router"]["w"])
    w[:, 1::2] = w[:, 0::2]
    jp = dict(jp, router={"w": w})
    tp = pm.from_reference(jp, t_moe.moe_spec(cfg), device="cpu")
    x = _x(4, (2, 24, cfg.d_model))
    _hold_layer(jcfg, cfg, jp, tp, x)
    probs = torch.softmax(torch.tensor(x).bfloat16().float() @ torch.tensor(w).bfloat16().float(), -1)
    assert torch.equal(probs[..., 0::2], probs[..., 1::2])
    _, te = t_moe.top_k_stable(probs, cfg.moe_top_k)
    _, je = jax.lax.top_k(jnp.asarray(probs.numpy()), cfg.moe_top_k)
    assert np.array_equal(te.numpy(), np.asarray(je))
    # each tied pair in the top k comes lower index first; a pair cut at the
    # k-th slot keeps its lower index
    for row in te.reshape(-1, cfg.moe_top_k).tolist():
        for j, ex in enumerate(row):
            if ex % 2:
                assert row[j - 1] == ex - 1


def dense_ref(p, x, cfg):
    """The reference test's dense all-experts MoE, in torch."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    probs = torch.softmax((xf @ p["router"]["w"]).float(), -1)
    gates, eidx = t_moe.top_k_stable(probs, cfg.moe_top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    h = F.silu(torch.einsum("td,edf->etf", xf, p["wi_gate"])) * torch.einsum("td,edf->etf", xf, p["wi_up"])
    y_all = torch.einsum("etf,efd->etd", h, p["wo"])
    y = torch.zeros(t, d)
    for j in range(cfg.moe_top_k):
        y = y + gates[:, j][:, None] * y_all[eidx[:, j], torch.arange(t)]
    return y.reshape(b, s, d)


def _port_layer(name, cf, seed):
    _, cfg = configs(name, moe_capacity_factor=cf)
    return cfg, pm.materialize(t_moe.moe_spec(cfg), torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", MOE)
def test_dropless_matches_dense_reference(name, seed):
    """Twin of the reference's hypothesis test, at fixed seeds: float32,
    capacity factor 8."""
    cfg, p = _port_layer(name, 8.0, seed)
    x = torch.tensor(_x(100 + seed, (2, 17, cfg.d_model), 0.5))
    y, aux = t_moe.moe(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), dense_ref(p, x, cfg).numpy(), rtol=5e-4, atol=5e-5)
    assert float(aux["lb_loss"]) >= 0.99  # lower-bounded by 1 at perfect balance
    assert float(aux["z_loss"]) >= 0


def test_capacity_drops_reduce_output_norm_not_nan():
    cfg, p = _port_layer("mixtral-8x7b", 0.25, 0)  # aggressive dropping
    x = torch.tensor(_x(0, (2, 33, cfg.d_model)))
    y, _ = t_moe.moe(p, x, cfg)
    assert bool(torch.isfinite(y).all())
    y_full, _ = t_moe.moe(p, x, cfg, capacity_factor=16.0)
    assert float(torch.linalg.norm(y)) <= float(torch.linalg.norm(y_full)) * 1.5


def test_single_token_decode_path():
    cfg, p = _port_layer("mixtral-8x7b", 8.0, 1)
    x = torch.tensor(_x(1, (4, 1, cfg.d_model)))
    y, _ = t_moe.moe(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), dense_ref(p, x, cfg).numpy(), rtol=5e-4, atol=5e-5)


# ------------------------------------------------------------ the MoE archs
@pytest.mark.parametrize("name", MOE)
def test_train_logits_match_reference(name):
    r = slice_run(name)
    assert np.isfinite(r["port_logits"]).all()
    assert rel_err(r["port_hidden"], r["ref_hidden"]) <= BOUND
    assert rel_err(r["port_logits"], r["ref_logits"]) <= BOUND


@pytest.mark.parametrize("name", MOE)
def test_prefill_matches_reference(name):
    r = slice_run(name)
    assert rel_err(r["port_prefill"], r["ref_prefill"]) <= BOUND
    for got, want in zip(r["port_cache"], r["ref_cache"], strict=True):
        assert got.shape == want.shape and rel_err(got, want) <= BOUND
    greedy_agrees(r["ref_prefill"], np.argmax(r["port_prefill"], -1))


@pytest.mark.parametrize("name", MOE)
def test_serve_steps_match_reference(name):
    r = slice_run(name)
    checked = 0
    for ref, port, tok in zip(r["ref_steps"], r["port_steps"], r["port_tok"]):
        assert rel_err(port, ref) <= BOUND
        checked += greedy_agrees(ref, tok)
    assert checked >= 1


@pytest.mark.parametrize("name", MOE)
def test_controls_fail_by_10x(name):
    jcfg, jm, jp, cfg, m, p = models(name)
    r = slice_run(name)
    toks, vis = inputs(cfg)
    _, textra = extras(vis)
    swapped = to_np(port_train_logits(m, swapped_layers(p), toks, textra)[1])
    no_rope = to_np(port_train_logits(build_model(dataclasses.replace(cfg, use_rope=False)), p, toks, textra)[1])
    assert rel_err(swapped, r["ref_logits"]) >= CONTROL_FACTOR * BOUND
    assert rel_err(no_rope, r["ref_logits"]) >= CONTROL_FACTOR * BOUND


def test_serve_step_greedy_chain():
    """Twin of the reference's on mixtral-8x7b."""
    serve_chain("mixtral-8x7b")
