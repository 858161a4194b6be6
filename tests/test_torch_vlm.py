"""PaliGemma (the ``vlm`` family) in the port: the bidirectional image
prefix and head_dim 256, on the CPU in float32, against the JAX package.

The Pallas flash kernel takes no prefix: the prefix-LM is the JAX model's
(``repro.models.attention.full_attention`` / ``flash_attention`` with
``prefix_len``), so the plain flash version is held to those two, and to
the Pallas kernels in interpret mode where no prefix is involved (D 256).
The CUDA kernels are held to the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.kernels import ops as jops
from repro.launch import steps as jsteps
from repro.models import attention as jattn
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.kernels import flash_attention as fa, ops
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.paged_attention import identity_block_table, paged_attention_plain
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.params import from_jax

ARCH = "paligemma-3b"
# float32 on both sides; attention outputs of order 1 (sums in another
# order), model logits of order 1 through a few smoke layers (the bar of
# tests/test_torch_models.py)
ATOL = 1e-5
ATOL_MODEL = 1e-4


def _qkv(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv)]


def _np(x):
    return np.array(x, np.float32)


def _cfgs(**kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    return j, t


def _params(jcfg, seed=0):
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _prefix(cfg, B, seed):
    """(B, n_prefix_tokens, d_model) patch embeddings (the SigLIP stub's
    output) from a numpy seed."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the prefix in flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Hkv", [1, 2])                  # MQA (paligemma's), GQA
@pytest.mark.parametrize("prefix_len", [0, 16, 130, 256])
def test_flash_plain_prefix_matches_the_jax_model_attention(prefix_len, Hkv):
    """Causal with a bidirectional prefix, S 300 (three 128-key steps, the
    last partial): a prefix past 128 keys makes the rows of the first step
    see keys of the later ones."""
    q, k, v = _qkv(2, 300, 4, Hkv, 32, prefix_len + Hkv)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                prefix_len=prefix_len).numpy()
    np.testing.assert_allclose(
        got, _np(jattn.full_attention(q, k, v, prefix_len=prefix_len)), atol=ATOL)
    np.testing.assert_allclose(
        got, _np(jattn.flash_attention(q, k, v, prefix_len=prefix_len, q_chunk=64,
                                       kv_chunk=64)), atol=ATOL)
    # the prefix's rows see more than their causal keys; the rows after it
    # see what they see without a prefix
    alone = flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_array_equal(got[:, prefix_len:], alone[:, prefix_len:])
    if prefix_len:
        assert not np.allclose(got[:, :prefix_len - 1], alone[:, :prefix_len - 1], atol=1e-3)


@pytest.mark.parametrize("kw", [{"causal": False}, {"window": 64}, {"use_pwl": True},
                                {"prefix_len": -1}])
def test_a_prefix_with_no_meaning_is_refused(kw):
    """A prefix without the causal mask, with a window or with PWL exp is
    refused, by the plain version, the dispatch and the CUDA wrapper (which
    checks its arguments before the device); a negative one too."""
    x = torch.zeros((1, 20, 2, 32))
    kw = {"prefix_len": 16, **kw}
    for fn in (flash_attention_plain, ops.flash_attention, flash_attention_cuda):
        with pytest.raises(ValueError, match="prefix"):
            fn(x, x, x, **kw)


def test_launch_keys_tell_a_prefix_apart():
    q = torch.zeros((4, 288, 8, 256), dtype=torch.bfloat16)
    k = torch.zeros((4, 288, 1, 256), dtype=torch.bfloat16)
    assert fa.launch_key(q, k, prefix_len=256) != fa.launch_key(q, k)
    assert "prefix=256" in fa.launch_key(q, k, prefix_len=256)


# ---------------------------------------------------------------------------
# head_dim 256 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,use_pwl", [(True, False), (True, True),
                                            (False, False), (False, True)])
def test_flash_plain_d256_matches_pallas_interpret(causal, use_pwl):
    """D 256, MQA, two 128-key steps; non-causal at a block-multiple Skv
    (the Pallas wrapper's padded keys would enter its softmax otherwise,
    ROADMAP hazard 2)."""
    q, k, v = _qkv(1, 256, 2, 1, 256, 40 + causal + 2 * use_pwl)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal,
                                use_pwl=use_pwl).numpy()
    want = _np(jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, use_pwl=use_pwl))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("use_pwl", [False, True])
def test_paged_plain_d256_matches_pallas_interpret(use_pwl):
    """D 256, MQA (8 query heads on one KV head, paligemma's), 64-token
    blocks of a contiguous cache, contexts of 0, a partial block and
    several blocks."""
    rng = np.random.default_rng(50 + use_pwl)
    B, max_len, H, Hkv, D, bt = 3, 192, 8, 1, 256, 64
    cache_k, cache_v = (rng.standard_normal((B, max_len, Hkv, D)).astype(np.float32)
                        for _ in range(2))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    table = identity_block_table(B, max_len, bt)
    ctx = np.asarray([0, 37, 190], np.int32)
    got = paged_attention_plain(torch.from_numpy(q),
                                torch.from_numpy(cache_k).view(-1, bt, Hkv, D),
                                torch.from_numpy(cache_v).view(-1, bt, Hkv, D), table,
                                torch.from_numpy(ctx), use_pwl=use_pwl).numpy()
    want = _np(jops.paged_attention(jnp.asarray(q), jnp.asarray(cache_k.reshape(-1, bt, Hkv, D)),
                                    jnp.asarray(cache_v.reshape(-1, bt, Hkv, D)),
                                    jnp.asarray(table.numpy()), jnp.asarray(ctx),
                                    use_pwl=use_pwl))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert not got[0].any()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_len", [0, 16])
def test_attn_sublayer_prefix_matches_jax_full(prefix_len):
    """The port's prefill attention (the flash plain version) against the
    JAX sublayer with the exact path the reference takes with a prefix
    (``impl="full"``, ``models/model.py:241``)."""
    from repro.models import attention as jattn_mod
    jcfg, tcfg = _cfgs()
    jp = jattn_mod.init_attention(jcfg, jax.random.PRNGKey(4))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 40, jcfg.d_model)).astype(np.float32)
    pos = np.arange(40)
    jout, (jk, jv) = jattn_mod.attn_sublayer(jcfg, jp, jnp.asarray(x), positions=pos,
                                             impl="full", prefix_len=prefix_len)
    tout, (tk, tv) = tattn.attn_sublayer(tcfg, tp, torch.from_numpy(x),
                                         positions=torch.from_numpy(pos),
                                         prefix_len=prefix_len)
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), _np(jv), atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"n_layers": 1, "head_dim": 256}],
                         ids=["smoke", "one_layer_d256"])
def test_forward_with_a_prefix_matches_jax(kw):
    """The smoke paligemma (2 layers, d 128, 4 heads on 1 KV head, head_dim
    32, a 16-row prefix, vocab 512), and one layer at head_dim 256: the
    text positions' logits and the collected cache (prefix and text rows,
    zeros after) against JAX's forward, jitted without a sharding context
    (ROADMAP hazard 1)."""
    jcfg, tcfg = _cfgs(**kw)
    jp, tp = _params(jcfg, seed=1)
    B, S, kv_max = 2, 21, 48
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    pre = _prefix(jcfg, B, seed=3)
    jl, _, jc = jax.jit(lambda p, t, e: jmodels.forward(
        jcfg, p, t, prefix_embeds=e, collect_cache=True, kv_max=kv_max))(
            jp, jnp.asarray(toks), jnp.asarray(pre))
    tl, _, tc = tmodels.forward(tcfg, tp, torch.from_numpy(toks),
                                prefix_embeds=torch.from_numpy(pre),
                                collect_cache=True, kv_max=kv_max)
    assert tuple(tl.shape) == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL_MODEL)
    for name in ("k", "v"):
        got = tc["b0_dense"][name]
        assert got.shape[2] == kv_max and not got[:, :, jcfg.n_prefix_tokens + S:].any()
        np.testing.assert_allclose(got.numpy(), _np(jc["b0_dense"][name]), atol=ATOL_MODEL)
    # the prefix changes every text position's logits
    plain, _, _ = tmodels.forward(tcfg, tp, torch.from_numpy(toks))
    assert not torch.allclose(plain, tl, atol=1e-3)


def test_prefill_with_a_prefix_then_serve_steps_give_the_jax_ids():
    """``make_prefill_step`` with ``prefix_embeds`` and then 6 serve steps
    over a cache of prefix + prompt rows: the greedy ids of JAX's jitted
    steps at every step, and the step logits within the model bar."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=5)
    B, S, steps = 2, 13, 6
    P = jcfg.n_prefix_tokens
    max_len = P + S + steps + 3
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (B, S))
    pre = _prefix(jcfg, B, seed=7)
    jtok, jc = jax.jit(jsteps.make_prefill_step(jcfg, kv_max=max_len))(
        jp, {"tokens": jnp.asarray(toks), "prefix_embeds": jnp.asarray(pre)})
    ttok, tc = tsteps.make_prefill_step(tcfg, kv_max=max_len)(
        tp, {"tokens": torch.from_numpy(toks), "prefix_embeds": torch.from_numpy(pre)})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    jdecode = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    serve = tsteps.make_serve_step(tcfg)
    for i in range(steps):
        n = P + S + i + 1
        jl, _ = jdecode(jp, jtok, jc, jnp.int32(n))
        tl, _ = tmodels.decode_step(tcfg, tp, ttok,
                                    {k: {m: t.clone() for m, t in e.items()}
                                     for k, e in tc.items()}, n)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL_MODEL)
        jtok, jc = jserve(jp, jc, jtok, jnp.int32(n))
        ttok, tc = serve(tp, tc, ttok, n)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")


def test_decode_continues_a_prefix_prefill():
    """prefill(prefix, S-1) + decode(1) equals forward(prefix, S) at the
    last token: the new token sees every cached row, prefix included."""
    _, tcfg = _cfgs()
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(8))
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tcfg.vocab_size, (2, 10)))
    pre = torch.from_numpy(_prefix(tcfg, 2, seed=9))
    full, _, _ = tmodels.forward(tcfg, tp, toks, prefix_embeds=pre)
    _, _, cache = tmodels.forward(tcfg, tp, toks[:, :9], prefix_embeds=pre,
                                  collect_cache=True, kv_max=32)
    lg, _ = tmodels.decode_step(tcfg, tp, toks[:, 9:], cache, tcfg.n_prefix_tokens + 10)
    err = (lg[:, 0] - full[:, -1]).abs().max().item()
    assert err / full[:, -1].abs().max().item() < 1e-5


def test_prefix_embeds_are_checked():
    _, tcfg = _cfgs()
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((2, 3), dtype=torch.long)
    for bad in ((1, 4, tcfg.d_model), (2, 4, tcfg.d_model + 1), (2, tcfg.d_model)):
        with pytest.raises(ValueError, match="prefix_embeds"):
            tmodels.forward(tcfg, tp, toks, prefix_embeds=torch.zeros(bad))
