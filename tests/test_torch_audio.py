"""The port's audio family (whisper's encoder-decoder) against the JAX package.

Both packages get the same weights (the JAX init, with its LayerNorm
scales and biases and the MLP biases moved off 1 and 0 by the same numpy
draws, carried over with ``repro_torch.params.from_jax``) and the same
numpy token ids and frame embeddings, in float32 on the CPU, where the
port's flash and paged attention run their plain versions.  The JAX side
is bare ``forward`` / ``decode_step`` / step functions, jitted without a
sharding context (ROADMAP hazard 1).  The JAX reference attends with the
exact ``full_attention`` in the encoder (at <= 2048 frames) and in the
cross-attention, so a ragged encoder length (100) is held as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as jmodel
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.model import cross_rows
from repro_torch.params import from_jax

ARCH = "whisper-large-v3"
# float32 on both sides, a 2 + 2 layer smoke model with logits of order 1:
# the bar of tests/test_torch_models.py
ATOL = 1e-4


def _cfgs(**kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    return j, t


def _params(jcfg, seed=0):
    """The JAX init with every norm scale / bias and MLP bias moved by
    0.1 * N(0, 1) (the init leaves them at 1 and 0, which would hide a
    missing or misplaced one), as numpy for JAX and tensors for the port."""
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, leaf):
        a = np.array(leaf)
        if path[-1].key in ("scale", "bias", "b_up", "b_down"):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype)
        return a
    jp = jax.tree_util.tree_map_with_path(perturb, jp)
    return jax.tree.map(jnp.asarray, jp), from_jax(jp, "cpu")


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    emb = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return toks, emb


# ---------------------------------------------------------------------------
# Sinusoidal positions (ROADMAP hazard 9)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d_model", [(64, 128), (100, 128), (1500, 1280)])
def test_sinusoidal_positions_match_jax_within_a_step_of_the_angle(seq, d_model):
    """The table and the embedding at each position against JAX's.  The
    angle reaches ``seq - 1`` radians; |sin a - sin a'| <= |a - a'|, and the
    two packages' angles (XLA's and torch's pow of 10000) may differ by one
    float32 step of the largest, which bounds both: 1.22e-4 at 1500 (JAX's
    own jitted sinusoidal_at and its table differ by that much too)."""
    tol = float(np.spacing(np.float32(seq - 1)))
    want = np.asarray(jcommon.sinusoidal_positions(seq, d_model))
    got = tcommon.sinusoidal_positions(seq, d_model)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d_model)
    assert np.abs(got.numpy() - want).max() <= tol
    pos = np.arange(seq, dtype=np.int32)
    want_at = np.asarray(jax.jit(jax.vmap(
        lambda p: jcommon.sinusoidal_at(p, d_model)))(jnp.asarray(pos)))
    got_at = torch.stack([tcommon.sinusoidal_at(torch.tensor(int(p)), d_model) for p in pos])
    assert np.abs(got_at.numpy() - want_at).max() <= tol
    # an int and a 0-dim tensor give the same bits, and the port's table row
    for p in (0, 1, seq // 2, seq - 1):
        assert torch.equal(tcommon.sinusoidal_at(p, d_model), got_at[p])
        assert torch.equal(got_at[p], got[p])


def test_sinusoidal_at_keeps_its_divisors():
    """The decode step's position reads one kept divisor vector per device
    (a captured step does not rebuild it), equal to the table's."""
    a = tcommon._sinusoidal_divisors(1280, "cpu")
    assert a is tcommon._sinusoidal_divisors(1280, "cpu")
    dim = torch.arange(640, dtype=torch.float32)
    assert torch.equal(a, 10000 ** (2 * dim / 1280))


# ---------------------------------------------------------------------------
# Encoder and cross-attention
# ---------------------------------------------------------------------------

def _jax_encoder(jcfg, jp, emb):
    """repro.models.model.forward's encoder lines (:224-236), written out:
    embeddings plus positions, the encoder blocks, the final norm."""
    e = emb.astype(jnp.float32)
    e = e + jcommon.sinusoidal_positions(e.shape[1], jcfg.d_model)[None]
    ectx = jmodel.FwdCtx(positions=jnp.arange(e.shape[1]), causal=False, impl="full")

    def body(h, lp):
        h, _, _ = jmodel._block_forward(jcfg, "enc", lp, h, ectx)
        return h, None
    e, _ = jax.lax.scan(body, e, jp["encoder"]["layers"])
    return jcommon.apply_norm(jcfg, jp["encoder"]["final_norm"], e)


@pytest.mark.parametrize("encoder_seq", [64, 100])
def test_encoder_matches_jax(encoder_seq):
    jcfg, tcfg = _cfgs(encoder_seq=encoder_seq)
    jp, tp = _params(jcfg)
    _, emb = _inputs(jcfg, 2, 1, seed=3)
    want = jax.jit(lambda p, e: _jax_encoder(jcfg, p, e))(jp, jnp.asarray(emb))
    got = tmodels.encode(tcfg, tp, torch.from_numpy(emb))
    assert tuple(got.shape) == (2, encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cross_attention_prefill_and_decode_match_jax():
    """The decoder's cross-attention sublayer (prefill: q of 9 rows
    against K/V of 100 frames, non-causal flash) and its decode form (one
    row through the paged path over the padded cross cache) against the
    JAX model's inline ``full_attention`` (model.py:141-152, :295-300)."""
    jcfg, tcfg = _cfgs(encoder_seq=100)
    jp, tp = _params(jcfg)
    p_j = jax.tree.map(lambda a: a[0], jp["layers"]["b0_dec"]["cross"])
    p_t = {k: v[0] for k, v in tp["layers"]["b0_dec"]["cross"].items()}
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 100, jcfg.d_model)).astype(np.float32)

    def jax_cross(p, h, enc):
        q, _, _ = jattn.qkv_project(jcfg, p, h)
        ek = (enc @ p["wk"]).reshape(2, 100, jcfg.n_kv_heads, jcfg.head_dim)
        ev = (enc @ p["wv"]).reshape(2, 100, jcfg.n_kv_heads, jcfg.head_dim)
        co = jattn.full_attention(q, ek, ev, causal=False)
        return co.reshape(*h.shape[:2], jcfg.q_dim) @ p["wo"], ek, ev
    want, wk, wv = jax.jit(jax_cross)(p_j, h, enc)
    got, (gk, gv) = tattn.cross_attn_sublayer(tcfg, p_t, torch.from_numpy(h),
                                              torch.from_numpy(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL)

    rows = cross_rows(100)
    assert rows == 128
    ck, cv = (torch.zeros((2, rows) + tuple(t.shape[2:])) for t in (gk, gv))
    ck[:, :100], cv[:, :100] = gk, gv
    table = torch.arange(2 * 2, dtype=torch.int32).reshape(2, 2)      # bt 64
    lens = torch.full((2,), 100, dtype=torch.int32)
    got = tattn.cross_attn_decode_sublayer(tcfg, p_t, torch.from_numpy(h[:, -1:]), ck, cv,
                                           block_table=table, context_lens=lens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1:], atol=ATOL)


# ---------------------------------------------------------------------------
# The model: forward, caches, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("encoder_seq", [64, 100])
def test_forward_caches_and_decode_match_jax(encoder_seq):
    """Prefill logits; self caches, and cross caches on rows
    [:encoder_seq] with zeros past them; then 5 decode steps with
    cache_len a 0-dim tensor: logits, caches and greedy ids."""
    jcfg, tcfg = _cfgs(encoder_seq=encoder_seq)
    jp, tp = _params(jcfg)
    B, S, kv_max = 2, 11, 24
    toks, emb = _inputs(jcfg, B, S, seed=1)
    jl, _, jc = jax.jit(lambda p, t, e: jmodels.forward(
        jcfg, p, t, encoder_embeds=e, collect_cache=True, kv_max=kv_max))(
            jp, jnp.asarray(toks), jnp.asarray(emb))
    tl, _, tc = tmodels.forward(tcfg, tp, torch.from_numpy(toks),
                                encoder_embeds=torch.from_numpy(emb),
                                collect_cache=True, kv_max=kv_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    assert tc.keys() == jc.keys() == {"b0_dec"}
    assert tc["b0_dec"].keys() == jc["b0_dec"].keys()

    def check_cache(n):
        for name, arr in jc["b0_dec"].items():
            got, want = tc["b0_dec"][name], np.asarray(arr)
            if name in ("k", "v"):
                got, want = got[:, :, :n], want[:, :, :n]
            else:
                assert got.shape[2] == cross_rows(encoder_seq)
                assert want.shape[2] == encoder_seq
                assert not got[:, :, encoder_seq:].any(), f"{name} past encoder_seq"
                got = got[:, :, :encoder_seq]
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, err_msg=name)
    check_cache(S)
    step = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    tok = np.array(jnp.argmax(jl[:, -1:], axis=-1))
    assert np.array_equal(tok, tl[:, -1:].argmax(-1).numpy())
    for i in range(5):
        n = S + i + 1
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(n))
        tl, tc = tmodels.decode_step(tcfg, tp, torch.from_numpy(tok), tc, torch.tensor(n))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        check_cache(n)
        tok = np.array(jnp.argmax(jl, axis=-1))
        assert np.array_equal(tok, tl.argmax(-1).numpy()), f"step {i}"


@pytest.mark.parametrize("encoder_seq", [64, 100])
def test_prefill_and_serve_steps_give_the_jax_greedy_ids(encoder_seq):
    """make_prefill_step with ``encoder_embeds`` in the batch, then 8
    serve steps with cache_len as an int: the JAX steps' ids."""
    jcfg, tcfg = _cfgs(encoder_seq=encoder_seq)
    jp, tp = _params(jcfg, seed=1)
    B, S, steps, max_len = 3, 4, 8, 16
    toks, emb = _inputs(jcfg, B, S, seed=2)
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, kv_max=max_len))
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    tok, cache = jprefill(jp, {"tokens": jnp.asarray(toks), "encoder_embeds": jnp.asarray(emb)})
    want = [np.asarray(tok)]
    for i in range(steps):
        tok, cache = jserve(jp, cache, tok, jnp.int32(S + i + 1))
        want.append(np.asarray(tok))
    tok, cache = tsteps.make_prefill_step(tcfg, kv_max=max_len)(
        tp, {"tokens": torch.from_numpy(toks), "encoder_embeds": torch.from_numpy(emb)})
    serve = tsteps.make_serve_step(tcfg)
    got = [tok.numpy()]
    for i in range(steps):
        tok, cache = serve(tp, cache, tok, S + i + 1)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))
    assert cache["b0_dec"]["k"].shape[2] == max_len


def test_decode_continues_the_prefill():
    """prefill(S-1) + decode(1) == forward(S) at the last token, on the
    port (tests/test_models.py:test_decode_matches_forward's check)."""
    _, tcfg = _cfgs(encoder_seq=100)
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(2))
    toks, emb = _inputs(tcfg, 2, 12, seed=5)
    toks, emb = torch.from_numpy(toks), torch.from_numpy(emb)
    full, _, _ = tmodels.forward(tcfg, tp, toks, encoder_embeds=emb)
    _, _, cache = tmodels.forward(tcfg, tp, toks[:, :11], encoder_embeds=emb,
                                  collect_cache=True, kv_max=16)
    lg, _ = tmodels.decode_step(tcfg, tp, toks[:, 11:], cache, 12)
    err = (lg[:, 0] - full[:, -1]).abs().max().item()
    assert err / full[:, -1].abs().max().item() < 1e-5


def test_encoder_inputs_are_checked():
    """An encoder-decoder needs its frames, a cache needs encoder_seq of
    them, no other family takes them, and a prefix must be (B, P, d_model)."""
    _, tcfg = _cfgs()
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="encoder_embeds"):
        tmodels.forward(tcfg, tp, toks)
    short = torch.zeros((1, tcfg.encoder_seq - 1, tcfg.d_model))
    with pytest.raises(ValueError, match="encoder_seq"):
        tmodels.forward(tcfg, tp, toks, encoder_embeds=short, collect_cache=True)
    logits, _, _ = tmodels.forward(tcfg, tp, toks, encoder_embeds=short)
    assert tuple(logits.shape) == (1, 3, tcfg.vocab_size)
    dense = dataclasses.replace(tconfigs.get_smoke_config("llama3-8b"), dtype="float32")
    dp = tmodels.init_params(dense, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no encoder_embeds"):
        tmodels.forward(dense, dp, toks, encoder_embeds=short)
    with pytest.raises(ValueError, match="prefix_embeds"):
        tsteps.make_prefill_step(dense, kv_max=8)(
            dp, {"tokens": toks, "prefix_embeds": torch.zeros((1, 2, dense.d_model + 1))})


def test_launch_keys_tell_whispers_attention_shapes_apart():
    """Each attention shape of whisper's serving path is counted under a key
    of its own: the encoder, the decoder's causal self-attention and the
    cross prefill in flash; the self and the cross cache in paged.  A reset
    clears the per-shape counts with the others."""
    from repro_torch.kernels import flash_attention as fa, ops, paged_attention as pa
    b, h, d, frames, prompt = 4, 20, 64, 1500, 4
    t = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    enc, dec = t(b, frames, h, d), t(b, prompt, h, d)
    keys = {fa.launch_key(enc, enc, causal=False), fa.launch_key(dec, dec),
            fa.launch_key(dec, enc, causal=False), fa.launch_key(dec, dec, causal=False)}
    assert len(keys) == 4
    # the wrappers pass the kernels' window argument (0: none)
    assert fa.launch_key(dec, dec, window=0) == fa.launch_key(dec, dec)
    q = t(b, h, d)
    self_key = pa.launch_key(q, t(b * 7, 64, h, d), torch.zeros((b, 7), dtype=torch.int32))
    cross_key = pa.launch_key(q, t(b * 24, 64, h, d), torch.zeros((b, 24), dtype=torch.int32))
    assert self_key != cross_key and "blocks24" in cross_key
    assert pa.launch_key(q, t(b * 7, 64, h, d), torch.zeros((b, 7), dtype=torch.int32),
                         window=0) == self_key
    ops.LAUNCHES_BY_SHAPE[("paged_attention", cross_key)] = 1
    ops.reset_launch_counts()
    assert ops.LAUNCHES_BY_SHAPE == {}


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--n-requests", "2", "--max-new", "3",
                 "--max-len", "32", "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")
