"""Shared inputs and runs of ``tests/test_torch_lm.py`` and
``tests/test_torch_lm_moe.py``: the LM scaffold's serving path in the JAX
package and in the port, on the same weights (the reference's
``params.materialize``, carried across with ``from_reference``) and the
same tokens (numpy, from a seed).

The reference runs as its launcher runs it: ``jax.jit`` of the train-mode
forward with its logits, of ``make_prefill_step`` and of
``make_serve_step``.  Three serve steps follow the prefill and
``pad_caches``; both sides are fed the reference's greedy tokens, so the
logits of every step are compared on the same inputs.

BOUND is the tolerance of every logit comparison: max |port - reference| at
most ``BOUND * max |reference logit|``, 2e-2, which ``chip_smoke.py``'s
phase 38 also holds the card to against the CPU.  On this CPU the port
gives the reference's bits on six of the seven archs at these sizes;
gemma3-27b, fourteen layers deep, measured 3.1e-3 (train), 3.6e-3 (prefill)
and 4.5e-3 (serve) of its max |logit| (0.63), where a float32 exp of XLA
and of torch an ulp apart moved one bf16 rounding and the difference grew
through the layers.  The controls (one layer's weights swapped with the
next's, RoPE skipped) measured 0.68-1.59 of max |logit|, 34x BOUND or more.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import smoke as j_smoke
from repro.models import build_model as j_build
from repro.models import params as j_pm
from repro.train import make_prefill_step as j_prefill_step
from repro.train import make_serve_step as j_serve_step
from repro.train import pad_caches as j_pad
from repro_torch.configs import ARCHS, smoke
from repro_torch.models import build_model
from repro_torch.models import params as pm
from repro_torch.train import make_prefill_step, make_serve_step, pad_caches

BOUND = 2e-2  # of max |reference logit|
CONTROL_FACTOR = 10  # a control must miss BOUND by this factor or more
DENSE = ["minitron-4b", "stablelm-12b", "gemma3-27b", "qwen1.5-32b", "qwen2-vl-72b"]
MOE = ["mixtral-8x7b", "qwen3-moe-30b-a3b"]
PORTED = DENSE + MOE
NOT_PORTED = ["whisper-medium", "mamba2-130m", "zamba2-7b"]
B, T, STEPS = 2, 24, 3


def configs(name, **over):
    """The reference's and the port's smoke config of ``name`` at dropless
    capacity (factor 8, as the reference's serving tests use)."""
    over = {"moe_capacity_factor": 8.0, **over}
    return dataclasses.replace(j_smoke(J_ARCHS[name]), **over), dataclasses.replace(smoke(ARCHS[name]), **over)


def rel_err(got, want):
    """max |got - want| / max |want|, in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def to_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def inputs(cfg, seed=0, t=T):
    """Tokens and, for the VLM, visual embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    vis = None
    if cfg.family == "vlm":
        vis = (rng.standard_normal((B, cfg.n_vis_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, vis


def extras(vis):
    return ({"visual_embeds": jnp.asarray(vis)}, {"visual_embeds": torch.tensor(vis)}) if vis is not None else ({}, {})


@functools.lru_cache(maxsize=None)
def models(name, seed=0):
    """``(jcfg, jmodel, jparams (numpy), cfg, model, params (CPU float32))``
    on the reference's weights from ``PRNGKey(seed)``."""
    jcfg, cfg = configs(name)
    jm, m = j_build(jcfg), build_model(cfg)
    jp = jax.device_get(j_pm.materialize(jm.spec(), jax.random.PRNGKey(seed)))
    return jcfg, jm, jp, cfg, m, pm.from_reference(jp, m.spec(), device="cpu")


def port_train_logits(m, p, toks, textra):
    h, _, _ = m.apply(p, torch.tensor(toks), mode="train", extra=textra)
    return h, m.logits(p, h)


@functools.lru_cache(maxsize=None)
def slice_run(name):
    """Both packages through train mode, prefill and three teacher-forced
    serve steps: a dict of numpy arrays, ``ref_*`` and ``port_*``."""
    jcfg, jm, jp, cfg, m, p = models(name)
    toks, vis = inputs(cfg)
    jextra, textra = extras(vis)
    out = {}

    def forward(p_, t_, e_):
        h = jm.apply(p_, t_, mode="train", extra=e_)[0]
        return h, jm.logits(p_, h)

    jh, jl = jax.jit(forward)(jp, jnp.asarray(toks), jextra)
    th, tl = port_train_logits(m, p, toks, textra)
    out.update(ref_hidden=to_np(jh), port_hidden=to_np(th), ref_logits=to_np(jl), port_logits=to_np(tl))

    jlog, jc = jax.jit(j_prefill_step(jm, jcfg))(jp, {"tokens": jnp.asarray(toks), **jextra})
    tlog, tc = make_prefill_step(m, cfg)(p, {"tokens": torch.tensor(toks), **textra})
    out.update(ref_prefill=to_np(jlog), port_prefill=to_np(tlog))
    out["ref_cache"] = [to_np(a) for a in jax.tree.leaves(jc)]
    out["port_cache"] = [to_np(tc[g][li][kv]) for g in sorted(tc) for li in sorted(tc[g]) for kv in ("k", "v")]

    jc, tc = j_pad(jc, T + STEPS), pad_caches(tc, T + STEPS)
    serve_j, serve_t = jax.jit(j_serve_step(jm, jcfg)), make_serve_step(m, cfg)
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)[:, None]
    ref_steps, port_steps, ref_tok, port_tok = [], [], [], []
    for i in range(STEPS):
        jt, jlg, jc = serve_j(jp, jc, jnp.asarray(tok), jnp.int32(T + i))
        tt, tlg, tc = serve_t(p, tc, torch.tensor(tok), T + i)
        ref_steps.append(to_np(jlg))
        port_steps.append(to_np(tlg))
        ref_tok.append(np.asarray(jt))
        port_tok.append(tt.numpy())
        tok = np.asarray(jt)  # both sides take the reference's token
    out.update(ref_steps=ref_steps, port_steps=port_steps, ref_tok=ref_tok, port_tok=port_tok)
    return out


def greedy_agrees(ref_logits, port_tokens, bound=BOUND):
    """The port's greedy tokens equal the reference's argmax wherever the
    reference's top-2 margin exceeds ``bound * max |logit|``.  Returns the
    number of rows checked."""
    ref_logits = np.asarray(ref_logits, np.float64)
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    wide = (top2[:, 1] - top2[:, 0]) > bound * np.abs(ref_logits).max()
    want = np.argmax(ref_logits, axis=-1)
    assert np.array_equal(np.asarray(port_tokens).reshape(-1)[wide], want[wide])
    return int(wide.sum())


def swapped_layers(p):
    """``p`` with layers 0 and 1 of the first stack exchanged (a control)."""
    swap = pm.tree_map(lambda t: t[[1, 0] + list(range(2, t.shape[0]))], p["stacks"]["g0"])
    return dict(p, stacks=dict(p["stacks"], g0=swap))


def port_model(name, seed=0):
    """The port's smoke model of ``name`` on its own weights (a torch
    generator on the CPU)."""
    _, cfg = configs(name)
    m = build_model(cfg)
    return cfg, m, pm.materialize(m.spec(), torch.Generator().manual_seed(seed), "cpu")


def serve_chain(name):
    """Three chained serve steps after a prefill run and give in-vocab
    tokens and finite logits (the reference's ``test_serve_step_greedy_chain``)."""
    cfg, m, p = port_model(name)
    t, cap = 8, 16
    tokens = torch.tensor(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, t)))
    logits, caches = make_prefill_step(m, cfg)(p, {"tokens": tokens})
    caches = pad_caches(caches, cap)
    assert caches["g0"]["l0"]["k"].shape[2] == cap
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    serve = make_serve_step(m, cfg)
    for i in range(3):
        tok, logits, caches = serve(p, caches, tok, t + i)
        assert tok.shape == (2, 1) and tok.dtype == torch.int32
        assert int(tok.max()) < cfg.vocab_size and int(tok.min()) >= 0
        assert bool(torch.isfinite(logits).all())


def zero_caches(cache_spec):
    """Zero CPU tensors for a ``DecoderLM.cache_spec`` tree."""
    return pm.tree_map(lambda leaf: torch.zeros(leaf[0], dtype=leaf[2]), cache_spec)
