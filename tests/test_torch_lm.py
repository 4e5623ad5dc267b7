"""The LM scaffold's serving path in the port (``repro_torch.configs``,
``models``, ``train``, ``launch.serve``) held against the JAX package's
on this CPU, at ``smoke(cfg)`` widths, for the dense archs and the VLM;
the MoE archs are ``tests/test_torch_lm_moe.py``.

The weights are the reference's (``params.materialize``) carried across
with ``from_reference``; the tokens come from numpy seeds.  Tolerances:
every logit comparison to ``BOUND`` = 2e-2 of the reference's max |logit|
(``tests/torch_lm_common.py`` gives what was measured); the layers' bf16
outputs bitwise, except where a float32 exp of XLA and of torch an ulp
apart may move one bf16 rounding: there one bf16 ulp of the largest output
(2^-7 of max |y|).  The port's own serving twins keep the reference tests'
tolerances (1e-3 for prefill-then-decode against the full forward, 2e-5 for
the windowed cache).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs import base as j_base
from repro.launch import serve as j_launch
from repro.models import attention as j_att
from repro.models import blocks as j_blocks
from repro.models import layers as j_layers
from repro.models import params as j_pm
from repro.models.lm import cast_params as j_cast
import repro_torch.configs as TC
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_att
from repro_torch.models import blocks as t_blocks
from repro_torch.models import build_model
from repro_torch.models import layers as t_layers
from repro_torch.models import params as pm
from repro_torch.models.lm import cast_params
from repro_torch.train import pad_caches
from torch_lm_common import (
    BOUND,
    CONTROL_FACTOR,
    DENSE,
    NOT_PORTED,
    PORTED,
    configs,
    extras,
    port_model,
    serve_chain,
    inputs,
    models,
    port_train_logits,
    rel_err,
    slice_run,
    swapped_layers,
    to_np,
    greedy_agrees,
    zero_caches,
)

ULP_BF16 = 2.0**-7  # one bf16 ulp at magnitude 1 (8 significant bits)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("name", list(JC.ARCHS))
def test_config_equals_reference(name):
    assert list(TC.ARCHS) == list(JC.ARCHS)
    assert dataclasses.asdict(TC.ARCHS[name]) == dataclasses.asdict(JC.ARCHS[name])
    assert dataclasses.asdict(TC.smoke(TC.ARCHS[name])) == dataclasses.asdict(JC.smoke(JC.ARCHS[name]))
    t, j = TC.ARCHS[name], JC.ARCHS[name]
    assert (t.n_layers, t.shared_d) == (j.n_layers, j.shared_d)
    if j.n_heads:
        assert t.shared_head_dim == j.shared_head_dim


def test_shapes_and_registry_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}
    for arch in JC.ARCHS:
        for shape in JC.SHAPES:
            assert TC.cell_is_applicable(TC.get_arch(arch), TC.get_shape(shape)) == \
                JC.cell_is_applicable(JC.get_arch(arch), JC.get_shape(shape))
            assert TC.get_shape(shape).step == JC.get_shape(shape).step
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_arch("gpt-5")
    with pytest.raises(KeyError, match="unknown shape"):
        TC.get_shape("train_1m")
    assert dataclasses.asdict(TC.base.uniform_groups(3, "local", None)[0]) == \
        dataclasses.asdict(j_base.uniform_groups(3, "local", None)[0])
    assert TC.AIDW_WORKLOADS  # the AIDW exports stay


def test_full_configs_match_assignment():
    """Twin of the reference's: the FULL configs carry the exact assigned
    dimensions."""
    expect = {
        "whisper-medium": dict(d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096, vocab_size=51865, n_layers=24),
        "minitron-4b": dict(d_model=3072, n_heads=24, n_kv_heads=8, d_ff=9216, vocab_size=256000, n_layers=32),
        "stablelm-12b": dict(d_model=5120, n_heads=32, n_kv_heads=8, d_ff=13824, vocab_size=100352, n_layers=40),
        "gemma3-27b": dict(d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504, vocab_size=262144, n_layers=62),
        "qwen1.5-32b": dict(d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064, n_layers=64),
        "mamba2-130m": dict(d_model=768, vocab_size=50280, n_layers=24, ssm_state=128),
        "mixtral-8x7b": dict(d_model=4096, n_heads=32, n_kv_heads=8, vocab_size=32000, n_layers=32, n_experts=8,
                             moe_top_k=2, d_ff_expert=14336),
        "qwen3-moe-30b-a3b": dict(d_model=2048, n_heads=32, n_kv_heads=4, vocab_size=151936, n_layers=48,
                                  n_experts=128, moe_top_k=8, d_ff_expert=768),
        "qwen2-vl-72b": dict(d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568, vocab_size=152064, n_layers=80),
        "zamba2-7b": dict(d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336, vocab_size=32000, n_layers=81,
                          ssm_state=64),
    }
    for name, want in expect.items():
        cfg = TC.ARCHS[name]
        for k, v in want.items():
            assert getattr(cfg, k) == v, f"{name}.{k}: {getattr(cfg, k)} != {v}"


def test_param_counts_in_band():
    """Twin of the reference's, for the ported archs: total parameter counts
    sit near the advertised sizes (counted from the specs, nothing
    allocated)."""
    bands = {
        "minitron-4b": (3.5e9, 5.2e9),
        "stablelm-12b": (10e9, 14e9),
        "gemma3-27b": (24e9, 30e9),
        "qwen1.5-32b": (30e9, 36e9),
        "mixtral-8x7b": (44e9, 49e9),
        "qwen3-moe-30b-a3b": (28e9, 33e9),
        "qwen2-vl-72b": (68e9, 76e9),
    }
    assert sorted(bands) == sorted(PORTED)
    for name, (lo, hi) in bands.items():
        n = pm.count_params(build_model(TC.ARCHS[name]).spec())
        assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B not in [{lo / 1e9}, {hi / 1e9}]"


@pytest.mark.parametrize("name", PORTED)
def test_count_params_equals_reference(name):
    from repro.models import build_model as j_build

    spec, jspec = build_model(TC.ARCHS[name]).spec(), j_build(JC.ARCHS[name]).spec()
    assert pm.count_params(spec) == j_pm.count_params(jspec)
    # the same leaves, shapes, axes and init recipes, in the same order
    jleaves = jax.tree_util.tree_flatten_with_path(jspec, is_leaf=j_pm.is_spec)[0]
    assert [(tuple(k.key for k in path), tuple(s)) for path, s in jleaves] == \
        [(path, tuple(s)) for path, s in pm.leaves(spec)]


@pytest.mark.parametrize("name", NOT_PORTED)
def test_build_model_refuses_the_next_slice(name):
    with pytest.raises(NotImplementedError, match="slice 1b"):
        build_model(TC.ARCHS[name])
    with pytest.raises(NotImplementedError, match="slice 1b"):
        build_model(TC.smoke(TC.ARCHS[name]))


# ------------------------------------------------------------------- params
def test_materialize_is_seeded_leaf_by_leaf():
    spec = build_model(TC.smoke(TC.ARCHS["minitron-4b"])).spec()
    a = pm.materialize(spec, torch.Generator().manual_seed(3), "cpu")
    b = pm.materialize(spec, torch.Generator().manual_seed(3), "cpu")
    c = pm.materialize(spec, torch.Generator().manual_seed(4), "cpu", torch.bfloat16)
    for (path, s), (_, x), (_, y), (_, z) in zip(pm.leaves(spec), pm.leaves(a), pm.leaves(b), pm.leaves(c)):
        assert tuple(x.shape) == s.shape and x.dtype == torch.float32 and z.dtype == torch.bfloat16
        assert torch.equal(x, y)
        if s.init == "ones":
            assert bool((x == 1).all())
        elif s.init == "zeros":
            assert bool((x == 0).all())
        elif x.numel() >= 4096:
            scale = s.scale if s.scale is not None else 0.02
            assert abs(float(x.std()) / scale - 1) < 0.05 and not torch.equal(x, z.float())


def test_tree_map_walks_sorted_keys_with_paths_and_parallel_trees():
    """``params.tree_map``, the one walker of the port's nested dicts: keys
    in sorted order (``jax.tree``'s), leaves alongside from parallel trees,
    and each leaf's key path on request; ``leaves`` flattens in that order."""
    a = {"b": {"y": 1, "x": 2}, "a": 3}
    b = {"a": 10, "b": {"x": 20, "y": 30}}
    out = pm.tree_map(lambda u, v: u + v, a, b)
    assert out == {"a": 13, "b": {"x": 22, "y": 31}}
    assert list(out) == ["a", "b"] and list(out["b"]) == ["x", "y"]
    assert pm.tree_map(lambda path, u: path, a, with_path=True) == {"a": ("a",), "b": {"x": ("b", "x"), "y": ("b", "y")}}
    assert pm.leaves(a) == [(("a",), 3), (("b", "x"), 2), (("b", "y"), 1)]
    with pytest.raises(KeyError):
        pm.tree_map(lambda u, v: u, a, {"a": 1})


@pytest.mark.parametrize("name", PORTED)
def test_from_reference_uses_every_leaf_once(name):
    """Every leaf of the reference's tree becomes exactly one tensor of the
    port's (same path, same values, storage of its own), and the port's
    forward reads every one of them: each gets a gradient."""
    jcfg, jm, jp, cfg, m, _ = models(name)
    jflat = {tuple(k.key for k in path): np.asarray(a) for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
    p = pm.from_reference(jp, m.spec(), device="cpu")
    flat = dict(pm.leaves(p))
    assert set(flat) == set(jflat)
    assert len({t.data_ptr() for t in flat.values()}) == len(flat)
    for path, t in flat.items():
        assert np.array_equal(t.numpy(), jflat[path]), path
        t.requires_grad_(True)
    toks, vis = inputs(cfg)
    _, textra = extras(vis)
    _, logits = port_train_logits(m, p, toks, textra)
    logits.square().mean().backward()
    unused = [path for path, t in flat.items() if t.grad is None or not bool(t.grad.abs().sum() > 0)]
    assert not unused


def test_from_reference_refuses_a_tree_that_does_not_fit():
    jcfg, jm, jp, cfg, m, _ = models("minitron-4b")
    spec = m.spec()
    extra = dict(jp, stray={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra leaves .*stray"):
        pm.from_reference(extra, spec, device="cpu")
    missing = dict(jp, ln_f={})
    with pytest.raises(ValueError, match="missing leaves .*ln_f"):
        pm.from_reference(missing, spec, device="cpu")
    wrong = dict(jp, ln_f={"scale": np.ones(65, np.float32)})
    with pytest.raises(ValueError, match="ln_f/scale has shape"):
        pm.from_reference(wrong, spec, device="cpu")
    assert pm.from_reference(jp, spec, device="cpu", dtype=torch.bfloat16)["ln_f"]["scale"].dtype == torch.bfloat16


# ------------------------------------------------------------------- layers
def _bf16(seed, shape, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.tensor(a).bfloat16()


def _hold(got, want, ulps=0):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape
    if ulps == 0:
        assert np.array_equal(got, want), np.abs(got - want).max()
    else:
        assert np.abs(got - want).max() <= ulps * ULP_BF16 * np.abs(want).max()


def test_rmsnorm_and_layernorm_match_reference():
    jx, tx = _bf16(1, (2, 24, 64))
    scale = (1 + 0.1 * np.random.default_rng(2).standard_normal(64)).astype(np.float32)
    bias = (0.1 * np.random.default_rng(3).standard_normal(64)).astype(np.float32)
    jp, tp = {"scale": jnp.asarray(scale)}, {"scale": torch.tensor(scale)}
    _hold(t_layers.rmsnorm(cast_params(tp), tx), jax.jit(j_layers.rmsnorm)(j_cast(jp), jx))
    jq, tq = dict(jp, bias=jnp.asarray(bias)), dict(tp, bias=torch.tensor(bias))
    _hold(t_layers.layernorm(cast_params(tq), tx), jax.jit(j_layers.layernorm)(j_cast(jq), jx), ulps=1)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_and_mrope_match_reference(theta):
    jx, tx = _bf16(4, (2, 24, 4, 16))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    _hold(t_layers.apply_rope(tx, torch.tensor(pos), theta), jax.jit(
        lambda x: j_layers.apply_rope(x, jnp.asarray(pos), theta))(jx))
    mpos = np.stack([pos, pos // 2, pos % 5]).astype(np.int32)
    _hold(t_layers.apply_mrope(tx, torch.tensor(mpos), (4, 2, 2), theta), jax.jit(
        lambda x: j_layers.apply_mrope(x, jnp.asarray(mpos), (4, 2, 2), theta))(jx))
    with pytest.raises(ValueError, match="do not sum"):
        t_layers.apply_mrope(tx, torch.tensor(mpos), (4, 2, 1), theta)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    jspec, spec = j_layers.mlp_spec(64, 128, act), t_layers.mlp_spec(64, 128, act)
    jp = jax.device_get(j_pm.materialize(jspec, jax.random.PRNGKey(2)))
    tp = pm.from_reference(jp, spec, device="cpu")
    jx, tx = _bf16(5, (2, 24, 64))
    _hold(t_layers.mlp(cast_params(tp), tx, act), jax.jit(lambda p, x: j_layers.mlp(j_cast(p), x, act))(jp, jx),
          ulps=1)


def test_embed_unembed_and_sinusoid_match_reference():
    table = (np.random.default_rng(6).standard_normal((256, 64)) * 0.02).astype(np.float32)
    ids = np.random.default_rng(7).integers(0, 256, (2, 24)).astype(np.int32)
    je, te = j_layers.embed({"table": jnp.asarray(table)}, jnp.asarray(ids)), t_layers.embed(
        {"table": torch.tensor(table)}, torch.tensor(ids))
    _hold(te, je)
    jx, tx = _bf16(8, (2, 24, 64))
    _hold(t_layers.unembed({"table": torch.tensor(table)}, tx),
          jax.jit(j_layers.unembed)({"table": jnp.asarray(table)}, jx))
    # float32 sin and cos of the two libraries, a few ulps apart
    np.testing.assert_allclose(t_layers.sinusoidal_positions(24, 64, offset=3).numpy(),
                               np.asarray(j_layers.sinusoidal_positions(24, 64, offset=3)), rtol=0,
                               atol=4 * float(np.finfo(np.float32).eps))


# ---------------------------------------------------------------- attention
def _attn(name="gemma3-27b", **over):
    jcfg, cfg = configs(name, **over)
    jp = jax.device_get(j_pm.materialize(j_att.attn_spec(jcfg), jax.random.PRNGKey(1)))
    return jcfg, cfg, jp, pm.from_reference(jp, t_att.attn_spec(cfg), device="cpu")


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_attention_full_sequence_matches_reference(mode, window):
    jcfg, cfg, jp, tp = _attn()
    jx, tx = _bf16(9, (2, 24, 64))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    jo, jc = jax.jit(lambda p, x: j_att.attention(j_cast(p), x, cfg=jcfg, mode=mode, positions=jnp.asarray(pos),
                                                  window=window))(jp, jx)
    to, tc = t_att.attention(cast_params(tp), tx, cfg=cfg, mode=mode, positions=torch.tensor(pos), window=window)
    _hold(to, jo)
    assert (tc is None) == (jc is None) == (mode == "train")
    if tc is not None:
        _hold(tc["k"], jc["k"])
        _hold(tc["v"], jc["v"])


@pytest.mark.parametrize("window,cache_len", [(4, 4), (4, 12), (None, 12)])
def test_attention_decode_matches_reference(window, cache_len):
    """Decode step by step from zero caches: a window-sized cache is a ring
    buffer (slot pos % 4, wrapping from pos 4 on); a longer one writes at
    pos under the window's mask.  Outputs and caches at every step; the
    last step writes at pos == cache length, where the reference's
    ``dynamic_update_slice`` clamps the slot to the last one."""
    jcfg, cfg, jp, tp = _attn()
    step = jax.jit(lambda p, x, c, pos: j_att.attention(j_cast(p), x, cfg=jcfg, mode="decode",
                                                          positions=jnp.full((2, 1), pos, jnp.int32), cache=c,
                                                          pos=pos, window=window))
    shape = (2, cache_len, cfg.n_kv_heads, cfg.head_dim)
    jc = {"k": jnp.zeros(shape, jnp.bfloat16), "v": jnp.zeros(shape, jnp.bfloat16)}
    tc = {"k": torch.zeros(shape, dtype=torch.bfloat16), "v": torch.zeros(shape, dtype=torch.bfloat16)}
    tpc = cast_params(tp)
    for pos in list(range(10)) + [cache_len]:
        jx, tx = _bf16(20 + pos, (2, 1, 64))
        jo, jc = step(jp, jx, jc, jnp.int32(pos))
        to, tc2 = t_att.attention(tpc, tx, cfg=cfg, mode="decode", positions=torch.full((2, 1), pos),
                                  cache=tc, pos=torch.tensor(pos) if pos % 2 else pos, window=window)
        assert tc2 is tc  # written in place
        _hold(to, jo)
        _hold(tc["k"], jc["k"])
        _hold(tc["v"], jc["v"])


def test_cache_write_slot_clamps_as_dynamic_update_slice():
    assert [int(t_att.cache_write_slot(p, 12, False)) for p in (0, 11, 12, 40)] == [0, 11, 11, 11]
    assert [int(t_att.cache_write_slot(p, 4, True)) for p in (0, 3, 4, 9)] == [0, 3, 0, 1]


def test_attention_static_kv_and_cross_match_reference():
    jcfg, cfg, jp, tp = _attn("minitron-4b")
    jx, tx = _bf16(30, (2, 1, 64))
    jk, tk = _bf16(31, (2, 9, cfg.n_kv_heads, cfg.head_dim))
    jo, _ = jax.jit(lambda p, x, k: j_att.attention(j_cast(p), x, cfg=jcfg, mode="decode", use_rope=False,
                                                    cache={"k": k, "v": k}, static_kv=True))(jp, jx, jk)
    to, tc = t_att.attention(cast_params(tp), tx, cfg=cfg, mode="decode", use_rope=False,
                             cache={"k": tk, "v": tk}, static_kv=True)
    _hold(to, jo)
    assert tc["k"] is tk
    jenc, tenc = _bf16(32, (2, 7, 64))
    jx, tx = _bf16(33, (2, 5, 64))
    jo, _ = jax.jit(lambda p, x, e: j_att.attention(j_cast(p), x, cfg=jcfg, mode="train", causal=False,
                                                    use_rope=False, kv_x=e))(jp, jx, jenc)
    to, _ = t_att.attention(cast_params(tp), tx, cfg=cfg, mode="train", causal=False, use_rope=False, kv_x=tenc)
    _hold(to, jo)


# ------------------------------------------------------------------- blocks
@pytest.mark.parametrize("name,kind", [("minitron-4b", ("attn", "dense")), ("gemma3-27b", ("local", "dense")),
                                       ("qwen2-vl-72b", ("attn", "dense"))])
def test_block_apply_matches_reference(name, kind):
    jcfg, cfg = configs(name)
    jp = jax.device_get(j_pm.materialize(j_blocks.block_spec(jcfg, kind), jax.random.PRNGKey(3)))
    tp = pm.from_reference(jp, t_blocks.block_spec(cfg, kind), device="cpu")
    jx, tx = _bf16(40, (2, 24, 64))
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    mpos = np.stack([pos] * 3) if cfg.mrope_sections else None
    jo, _, jaux = jax.jit(lambda p, x: j_blocks.block_apply(
        j_cast(p), x, kind, cfg=jcfg, mode="train", positions=jnp.asarray(pos),
        mrope_positions=None if mpos is None else jnp.asarray(mpos)))(jp, jx)
    to, _, taux = t_blocks.block_apply(cast_params(tp), tx, kind, cfg=cfg, mode="train", positions=torch.tensor(pos),
                                       mrope_positions=None if mpos is None else torch.tensor(mpos))
    assert to.dtype == torch.float32  # the unrounded residual; the stack rounds it
    _hold(to.bfloat16(), jo)
    assert float(taux["lb_loss"]) == float(jaux["lb_loss"]) == 0.0


def test_blocks_refuse_the_mamba_mixer():
    cfg = TC.smoke(TC.ARCHS["mamba2-130m"])
    for call in (lambda: t_blocks.block_spec(cfg, ("mamba", None)),
                 lambda: t_blocks.block_cache_spec(cfg, ("mamba", None), 2, 8),
                 lambda: t_blocks.block_apply({}, None, ("mamba", None), cfg=cfg, mode="train")):
        with pytest.raises(NotImplementedError, match="slice 1b"):
            call()


# -------------------------------------------------------- the slice, per arch
@pytest.mark.parametrize("name", DENSE)
def test_train_logits_match_reference(name):
    r = slice_run(name)
    cfg = models(name)[3]
    assert r["port_hidden"].shape == (2, 24, cfg.d_model) and r["port_logits"].shape == (2, 24, cfg.vocab_size)
    assert np.isfinite(r["port_logits"]).all()
    assert rel_err(r["port_hidden"], r["ref_hidden"]) <= BOUND
    assert rel_err(r["port_logits"], r["ref_logits"]) <= BOUND


@pytest.mark.parametrize("name", DENSE)
def test_prefill_matches_reference(name):
    r = slice_run(name)
    assert rel_err(r["port_prefill"], r["ref_prefill"]) <= BOUND
    assert len(r["port_cache"]) == len(r["ref_cache"])
    for got, want in zip(r["port_cache"], r["ref_cache"]):
        assert got.shape == want.shape and rel_err(got, want) <= BOUND
    greedy_agrees(r["ref_prefill"], np.argmax(r["port_prefill"], -1))


@pytest.mark.parametrize("name", DENSE)
def test_serve_steps_match_reference(name):
    r = slice_run(name)
    checked = 0
    for ref, port, tok in zip(r["ref_steps"], r["port_steps"], r["port_tok"]):
        assert rel_err(port, ref) <= BOUND
        checked += greedy_agrees(ref, tok)
    assert checked >= 1


@pytest.mark.parametrize("name", DENSE)
def test_controls_fail_by_10x(name):
    """The check that passes above fails by 10x or more when layers 0 and 1
    swap their weights or when RoPE is skipped."""
    jcfg, jm, jp, cfg, m, p = models(name)
    r = slice_run(name)
    toks, vis = inputs(cfg)
    _, textra = extras(vis)
    swapped = to_np(port_train_logits(m, swapped_layers(p), toks, textra)[1])
    no_rope = to_np(port_train_logits(build_model(dataclasses.replace(cfg, use_rope=False)), p, toks, textra)[1])
    assert rel_err(swapped, r["ref_logits"]) >= CONTROL_FACTOR * BOUND
    assert rel_err(no_rope, r["ref_logits"]) >= CONTROL_FACTOR * BOUND


def test_vlm_merges_visual_embeddings_except_in_decode():
    jcfg, jm, jp, cfg, m, p = models("qwen2-vl-72b")
    toks, vis = inputs(cfg)
    _, textra = extras(vis)
    h1 = port_train_logits(m, p, toks, textra)[0]
    h0 = port_train_logits(m, p, toks, {})[0]
    assert not torch.equal(h1, h0)
    # the visual stub replaces the first n_vis_tokens embeddings only
    toks2 = toks.copy()
    toks2[:, :cfg.n_vis_tokens] = (toks2[:, :cfg.n_vis_tokens] + 1) % cfg.vocab_size
    assert torch.equal(port_train_logits(m, p, toks2, textra)[0], h1)
    # explicit M-RoPE positions equal to the default broadcast give the same bits
    mpos = torch.arange(24, dtype=torch.int32)[None].expand(3, 2, 24)
    h2, _, _ = m.apply(p, torch.tensor(toks), mode="train", extra={**textra, "mrope_positions": mpos})
    assert torch.equal(h2, h1)


# ---------------------------------------------- twins of the serving tests
@pytest.mark.parametrize("name", PORTED)
def test_prefill_decode_matches_full_forward(name):
    """Twin of the reference's: prefill T tokens then decode token T ==
    the full forward on T + 1 tokens (MoE at dropless capacity), within its
    1e-3 of max |logit|."""
    cfg, m, p = port_model(name)
    t, cap = 24, 32
    rng = np.random.default_rng(3)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (2, t + 1)))
    extra = {}
    if cfg.family == "vlm":
        extra["visual_embeds"] = torch.tensor(rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model)) * 0.1).float()
    h_full, _, _ = m.apply(p, tokens, mode="train", extra=extra)
    logits_full = m.logits(p, h_full)[:, -1]
    _, caches, _ = m.apply(p, tokens[:, :t], mode="prefill", extra=extra)
    caches = pad_caches(caches, cap)
    h_dec, new_caches, _ = m.apply(p, tokens[:, t:t + 1], mode="decode", caches=caches, pos=t, extra=extra)
    logits_dec = m.logits(p, h_dec)[:, -1]
    assert rel_err(logits_dec, logits_full) < 1e-3
    assert new_caches is not None


@pytest.mark.parametrize("name", ["minitron-4b"])
def test_serve_step_greedy_chain(name):
    """Twin of the reference's: three chained serve steps run and give
    in-vocab tokens (mixtral-8x7b: ``tests/test_torch_lm_moe.py``)."""
    serve_chain(name)


def test_windowed_equals_full_cache_decode():
    """Twin of ``tests/models/test_windowed_cache.py``: a sliding-window
    layer's window-sized ring buffer gives the full cache's logits at every
    decode step through the wrap (which starts at t = 4)."""
    base = dataclasses.replace(TC.smoke(TC.ARCHS["gemma3-27b"]), sliding_window=4)
    cfg_full = dataclasses.replace(base, windowed_cache=False)
    cfg_win = dataclasses.replace(base, windowed_cache=True)
    model_f, model_w = build_model(cfg_full), build_model(cfg_win)
    params = pm.materialize(model_f.spec(), torch.Generator().manual_seed(0), "cpu")
    b, t = 2, 12
    caches_f, caches_w = zero_caches(model_f.cache_spec(b, t)), zero_caches(model_w.cache_spec(b, t))
    sizes_f = sum(x.numel() for _, x in pm.leaves(caches_f))
    sizes_w = sum(x.numel() for _, x in pm.leaves(caches_w))
    assert sizes_w < sizes_f
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg_full.vocab_size, (b, t)))
    for step in range(t):
        tok = toks[:, step:step + 1]
        h_f, caches_f, _ = model_f.apply(params, tok, mode="decode", caches=caches_f, pos=step)
        h_w, caches_w, _ = model_w.apply(params, tok, mode="decode", caches=caches_w, pos=step)
        np.testing.assert_allclose(to_np(model_f.logits(params, h_f)), to_np(model_w.logits(params, h_w)),
                                   rtol=2e-5, atol=2e-5, err_msg=f"step {step} (window wrap starts at t=4)")


def test_windowed_decode_matches_reference():
    """The windowed model decoding from zero caches, held against the
    reference's at every step through the wrap."""
    over = dict(sliding_window=4, windowed_cache=True)
    jcfg, cfg = configs("gemma3-27b", **over)
    from repro.models import build_model as j_build

    jm, m = j_build(jcfg), build_model(cfg)
    jp = jax.device_get(j_pm.materialize(jm.spec(), jax.random.PRNGKey(5)))
    p = pm.from_reference(jp, m.spec(), device="cpu")
    b, t = 2, 10
    tc = zero_caches(m.cache_spec(b, t))
    jc = jax.tree.map(lambda leaf: jnp.zeros(leaf[0], leaf[2]), jm.cache_spec(b, t),
                      is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], tuple))
    assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == [tuple(x.shape) for _, x in pm.leaves(tc)]
    assert tc["g0"]["l0"]["k"].shape[2] == 4 and tc["g0"]["l5"]["k"].shape[2] == t  # local ring, global full
    step = jax.jit(lambda p_, c, x, pos: (lambda h, c2: (jm.logits(p_, h), c2))(
        *jm.apply(p_, x, mode="decode", caches=c, pos=pos)[:2]))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    for s in range(t):
        jl, jc = step(jp, jc, jnp.asarray(toks[:, s:s + 1]), jnp.int32(s))
        h, tc, _ = m.apply(p, torch.tensor(toks[:, s:s + 1]), mode="decode", caches=tc, pos=s)
        assert rel_err(to_np(m.logits(p, h)), to_np(jl)) <= BOUND, s


# ----------------------------------------------------------------- launcher
def test_launcher_loop_gives_the_reference_tokens():
    """``repro_torch.launch.serve.generate`` on the reference launcher's
    weights and token ids (``--arch minitron-4b --reduced``, seed 0) gives
    the reference launcher's greedy tokens wherever the reference's top-2
    margin exceeds BOUND (the port's own tokens feed its next step, as
    a server's do)."""
    argv = ["--arch", "minitron-4b", "--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "6"]
    ref_out = np.asarray(j_launch.main(argv))
    from repro.models import build_model as j_build

    jcfg = dataclasses.replace(JC.smoke(JC.ARCHS["minitron-4b"]), moe_capacity_factor=4.0)
    jm = j_build(jcfg)
    key = jax.random.PRNGKey(0)
    jp = jax.device_get(j_pm.materialize(jm.spec(), key))
    toks = np.asarray(jax.random.randint(key, (2, 8), 0, jcfg.vocab_size))
    cfg = dataclasses.replace(TC.smoke(TC.ARCHS["minitron-4b"]), moe_capacity_factor=4.0)
    m = build_model(cfg)
    out, t_prefill, t_decode = t_launch.generate(m, pm.from_reference(jp, m.spec(), device="cpu"),
                                                 torch.tensor(toks), 6)
    assert out.shape == (2, 6) and out.dtype == torch.int32 and t_prefill > 0 and t_decode > 0
    # the reference's margins along its own chain
    from repro.train import make_prefill_step as jpre, make_serve_step as jserve, pad_caches as jpad

    logits, caches = jax.jit(jpre(jm, jcfg))(jp, {"tokens": jnp.asarray(toks)})
    caches = jpad(caches, 14)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    chain = [np.asarray(logits)]
    serve = jax.jit(jserve(jm, jcfg))
    for i in range(5):
        tok, logits, caches = serve(jp, caches, tok, jnp.int32(8 + i))
        chain.append(np.asarray(logits))
    assert np.array_equal(np.stack([c.argmax(-1) for c in chain], 1), ref_out)
    got = out.numpy()
    for row in range(2):
        for s, logits in enumerate(chain):
            top2 = np.sort(logits[row])[-2:]
            if top2[1] - top2[0] <= BOUND * np.abs(logits).max():
                break  # past a near tie the two chains may part
            assert got[row, s] == ref_out[row, s], (row, s)


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_launch.main(["--arch", "minitron-4b", "--reduced"])
    out = t_launch.main(["--arch", "qwen2-vl-72b", "--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "10", "--gen", "3"])
    assert out.shape == (2, 3)
    text = capsys.readouterr().out
    assert "first call: prefill" in text and "warm: prefill" in text and "tok/s" in text
