"""The port's configs and dense model (repro_torch) against the JAX package.

Both packages get the same weights (the JAX init, carried over with
``repro_torch.params.from_jax``) and the same numpy inputs, in float32 on
the CPU, where the port's attention runs the kernels' plain versions.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.models import common as jcommon
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.models import common as tcommon
from repro_torch.params import from_jax

# float32 on both sides; matmul and softmax sums in another order through
# a 2-layer smoke model with logits of order 1
ATOL = 1e-4


def _cfgs(arch, **kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32", **kw)
    return j, t


def _params(jcfg, seed=0):
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_configs_equal_the_jax_registry(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) == \
        dataclasses.asdict(jconfigs.get_config(arch))
    t, j = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert t.n_params() == j.n_params()
    assert dataclasses.asdict(tconfigs.get_smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.get_smoke_config(arch))


def test_rmsnorm_layernorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    tx, ts, tb = map(torch.from_numpy, (x, scale, bias))
    np.testing.assert_allclose(tcommon.rmsnorm(tx, ts).numpy(),
                               np.asarray(jcommon.rmsnorm(x, scale)), atol=1e-6)
    np.testing.assert_allclose(tcommon.layernorm(tx, ts, tb).numpy(),
                               np.asarray(jcommon.layernorm(x, scale, bias)),
                               atol=1e-6)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            tcommon.apply_rope(tx, torch.from_numpy(pos.copy()), theta).numpy(),
            np.asarray(jcommon.apply_rope(x, pos, theta)), atol=1e-6)


def test_activations_match_jax():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    for name in ("swiglu", "geglu"):
        np.testing.assert_allclose(
            tcommon.ACTS[name](torch.from_numpy(x)).numpy(),
            np.asarray(jcommon.ACTS[name](jnp.asarray(x))), atol=1e-6)


def test_full_attention_matches_jax():
    from repro.models.attention import full_attention as jfull
    from repro_torch.models.attention import full_attention as tfull
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 32)).astype(np.float32)
            for _ in range(2))
    for kw in ({"causal": False}, {"causal": True, "q_offset": 8},
               {"causal": True, "window": 5, "q_offset": 8, "kv_len": 17},
               {"causal": True, "prefix_len": 6}):
        np.testing.assert_allclose(
            tfull(*map(torch.from_numpy, (q, k, v)), **kw).numpy(),
            np.asarray(jfull(q, k, v, **kw)), atol=1e-5)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_sublayer_matches_jax(mlp):
    from repro.models import mlp as jmlp
    from repro_torch.models import mlp as tmlp
    jcfg, tcfg = _cfgs("llama3-8b", mlp=mlp)
    jp = jmlp.init_mlp(jcfg, jax.random.PRNGKey(1))
    if mlp == "gelu":                           # non-zero biases
        jp = {**jp, "b_up": jp["b_up"] + 0.1, "b_down": jp["b_down"] - 0.1}
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp.keys() == tmlp.init_mlp(tcfg, torch.Generator()).keys()
    x = np.random.default_rng(3).standard_normal((2, 5, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tmlp.mlp_sublayer(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.mlp_sublayer(jcfg, jp, x)), atol=1e-5)


def test_from_jax_keeps_bfloat16():
    jcfg = jconfigs.get_smoke_config("llama3.2-1b")        # bfloat16 default
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    wq = tp["layers"]["b0_dense"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        wq.float().numpy(),
        np.asarray(jp["layers"]["b0_dense"]["attn"]["wq"], np.float32))


def _mirrors_the_jax_tree(arch):
    """The port's init_params of ``arch`` has the JAX tree's paths, shapes
    and dtype; returns the port's config and params."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda: jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tflat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = v
    walk(tp, ())
    assert len(tflat) == len(jleaves)
    for path, leaf in jleaves:
        t = tflat[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    return tcfg, tp


def test_init_params_mirrors_the_jax_tree():
    """llama3-8b, and whisper, whose ``encoder`` subtree (stacked encoder
    blocks, final norm) and decoder blocks (``lnx``, ``cross``) nest as in
    JAX, so that from_jax carries them as they are."""
    tcfg, tp = _mirrors_the_jax_tree("whisper-large-v3")
    assert tp["encoder"]["layers"]["attn"]["wq"].shape[0] == tcfg.n_encoder_layers
    assert {"lnx", "cross"} <= tp["layers"]["b0_dec"].keys()
    tcfg, tp = _mirrors_the_jax_tree("llama3-8b")
    # the JAX distributions: fan-in-scaled normals, 0.02 embedding, zero scales
    wq = tp["layers"]["b0_dense"]["attn"]["wq"]
    assert wq.shape[0] == tcfg.n_layers
    assert abs(wq.std().item() - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5
    assert abs(tp["embed"].std().item() - 0.02) < 0.002
    assert not tp["final_norm"]["scale"].any()
    assert "lm_head" in tp and not tcfg.tie_embeddings


DENSE_ARCHS = [a for a in tconfigs.list_archs()
               if tconfigs.get_config(a).family == "dense"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_and_decode_match_jax(arch):
    """Every dense arch at its smoke config, tied (llama3.2-1b, olmo-1b,
    smollm-360m) and untied heads: prefill logits and cache, then 4 decode
    steps' logits and cache rows."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    B, S, kv_max = 2, 37, 48
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, _, jc = jax.jit(lambda p, t: jmodels.forward(
        jcfg, p, t, collect_cache=True, kv_max=kv_max))(jp, jnp.asarray(toks))
    tl, _, tc = tmodels.forward(tcfg, tp, torch.from_numpy(toks),
                                collect_cache=True, kv_max=kv_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(tc["b0_dense"][kv].numpy(),
                                   np.asarray(jc["b0_dense"][kv]), atol=ATOL)
    step = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    tok = toks[:, -1:]
    for i in range(4):
        n = S + i + 1
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(n))
        tl, tc = tmodels.decode_step(tcfg, tp, torch.from_numpy(tok), tc, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        for kv in ("k", "v"):
            np.testing.assert_allclose(tc["b0_dense"][kv][:, :, :n].numpy(),
                                       np.asarray(jc["b0_dense"][kv][:, :, :n]),
                                       atol=ATOL)
        tok = np.array(jnp.argmax(jl, axis=-1))


def test_init_cache_matches_jax_layout():
    """llama3-8b, and whisper at encoder_seq 64 and 100: the same entries,
    self caches of the JAX shape; the port's cross cache has
    cross_rows(encoder_seq) rows (a multiple of 64) where JAX's has
    encoder_seq, and is otherwise of its shape."""
    from repro_torch.models.model import cross_rows
    for arch, kw in (("llama3-8b", {}), ("whisper-large-v3", {}),
                     ("whisper-large-v3", {"encoder_seq": 100})):
        jcfg, tcfg = _cfgs(arch, **kw)
        jc = jmodels.init_cache(jcfg, 3, 40)
        tc = tmodels.init_cache(tcfg, 3, 40, device="cpu")
        assert tc.keys() == jc.keys()
        for key in jc:
            assert tc[key].keys() == jc[key].keys()
            for name, want in jc[key].items():
                shape = list(want.shape)
                if name.startswith("cross"):
                    shape[2] = cross_rows(jcfg.encoder_seq)
                    assert shape[2] % 64 == 0 and shape[2] - 64 < want.shape[2]
                assert list(tc[key][name].shape) == shape
                assert not tc[key][name].any()


def test_unported_families_and_variants_raise():
    """The vlm family (paligemma) initialises as the dense stack, with the
    JAX tree's paths and shapes, and attention takes a bidirectional
    prefix; what is still unported raises: a prefix with a window, with
    PWL exp or without the causal mask, which nothing in the reference
    defines."""
    from repro_torch.models import attention as tattn
    tcfg, tp = _mirrors_the_jax_tree("paligemma-3b")
    assert tcfg.family == "vlm" and tcfg.tie_embeddings and "lm_head" not in tp
    assert tmodels.group_layout(tcfg) == (("dense",), tcfg.n_layers)
    _, dense = _cfgs("llama3-8b")
    p = tattn.init_attention(dense, torch.Generator().manual_seed(0))
    x = torch.randn((1, 20, dense.d_model), generator=torch.Generator().manual_seed(1))
    out, _ = tattn.attn_sublayer(dense, p, x, positions=torch.arange(20), prefix_len=16)
    causal, _ = tattn.attn_sublayer(dense, p, x, positions=torch.arange(20))
    assert torch.equal(out[:, 16:], causal[:, 16:])
    assert not torch.allclose(out[:, :15], causal[:, :15])
    for kw in ({"window": 8}, {"causal": False}):
        with pytest.raises(ValueError, match="prefix"):
            tattn.attn_sublayer(dense, p, x, positions=torch.arange(20), prefix_len=16, **kw)
