"""The port's SSM and hybrid families (repro_torch) against the JAX package.

Both packages get the same weights (the JAX init, carried over with
``repro_torch.params.from_jax``) and the same numpy inputs, in float32 on
the CPU, where ``kernels.ops.ssd_scan`` runs its plain version.  The JAX
side is built from bare ``forward`` / ``decode_step`` / step functions,
jitted without a sharding context (ROADMAP hazard 1).
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
from repro.kernels import ref
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import kernel_layout, ssd_scan_cuda, ssd_scan_plain
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as tssm
from repro_torch.params import from_jax
from test_torch_serve import _jax_server_loop

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
# float32 on both sides.  The scan: sums of up to chunk * N products of
# order 1 taken in another order (einsum contraction order, cumsum) on y of
# order 1-10.  The models: a few layers with logits of order 1.
SSD_ATOL = 1e-4
ATOL = 1e-4


def _np(x):
    return np.array(x, np.float32)


def _cfgs(arch, **kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32", **kw)
    return j, t


def _params(jcfg, seed=0):
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _ssd_inputs(seed, b, S, H, P, N, dt_shift=0.0):
    """The scales of tests/test_kernels.py: unit x, softplus(normal) dt,
    A near -1, B and C at 0.3.  ``dt_shift`` -5 gives dt ~ 0.01, the long
    memory of trained Mamba2 weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) + dt_shift)).astype(np.float32)
    a = -np.exp(0.2 * rng.standard_normal(H)).astype(np.float32)
    B = (0.3 * rng.standard_normal((b, S, N))).astype(np.float32)
    C = (0.3 * rng.standard_normal((b, S, N))).astype(np.float32)
    return x, dt, a, B, C


def _plain(args, chunk):
    y, state = ssd_scan_plain(*map(torch.from_numpy, args), chunk)
    return y.numpy(), state.numpy()


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,S,H,P,N,chunk", [(2, 128, 2, 32, 16, 32),
                                             (1, 256, 4, 16, 8, 64),
                                             (2, 64, 1, 64, 32, 64)])
def test_ssd_plain_matches_pallas_interpret(b, S, H, P, N, chunk):
    args = _ssd_inputs(S + H, b, S, H, P, N)
    y, _ = _plain(args, chunk)
    want = _np(jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk))
    np.testing.assert_allclose(y, want, atol=SSD_ATOL)


@pytest.mark.parametrize("b,S,H,P,N,chunk", [(2, 100, 3, 16, 8, 32),   # ragged
                                             (1, 300, 2, 32, 16, 256),  # ragged
                                             (2, 20, 2, 16, 16, 256),   # S < chunk
                                             (1, 96, 2, 16, 8, 32)])
def test_ssd_plain_matches_ssd_chunked_and_the_recurrence(b, S, H, P, N, chunk):
    args = _ssd_inputs(S, b, S, H, P, N)
    y, state = _plain(args, chunk)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(y, _np(jy), atol=SSD_ATOL)
    np.testing.assert_allclose(state, _np(jstate), atol=SSD_ATOL)
    # the step-by-step recurrence sums in its own order over all S rows
    rec = _np(ref.ref_ssd_recurrent(*map(jnp.asarray, args)))
    np.testing.assert_allclose(y, rec, atol=1e-3)


@pytest.mark.parametrize("b,S,H,P,N,chunk", [(2, 100, 3, 16, 8, 32),   # ragged
                                             (1, 256, 2, 32, 16, 64),
                                             (2, 20, 2, 16, 16, 256)])  # S < chunk
def test_ssd_plain_carries_long_memory(b, S, H, P, N, chunk):
    """dt ~ 0.01: the state decays by ~e^-0.3 per 32 rows, so what a chunk
    carries to the next is most of the result.  y and state are held to
    1e-4 of their own max |value| against ssd_chunked, the recurrence and
    the plain version at another chunk length."""
    args = _ssd_inputs(S + 7, b, S, H, P, N, dt_shift=-5.0)
    y, state = _plain(args, chunk)
    jy, jstate = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    rec = _np(ref.ref_ssd_recurrent(*map(jnp.asarray, args)))
    y8, s8 = _plain(args, 8)
    for got, want in ((y, _np(jy)), (state, _np(jstate)), (y, rec), (y8, y), (s8, state)):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_ssd_plain_chunk_invariance_and_padding():
    """The chunk length is not part of the result, and rows of dt = 0
    past the end change neither y nor the state."""
    args = _ssd_inputs(9, 1, 70, 2, 16, 8)
    y8, s8 = _plain(args, 8)
    y70, s70 = _plain(args, 70)
    np.testing.assert_allclose(y8, y70, atol=SSD_ATOL)
    np.testing.assert_allclose(s8, s70, atol=SSD_ATOL)
    x, dt, a, B, C = args
    padded = [np.concatenate([t, np.zeros_like(t[:, :10])], 1)
              for t in (x, dt)] + [a] + [
              np.concatenate([t, np.ones_like(t[:, :10])], 1) for t in (B, C)]
    yp, sp = _plain(padded, 8)
    np.testing.assert_allclose(yp[:, :70], y8, atol=1e-6)
    np.testing.assert_allclose(sp, s8, atol=1e-6)


def test_ssd_dispatch_and_cuda_wrapper_checks():
    args = [torch.from_numpy(t) for t in _ssd_inputs(1, 1, 40, 2, 32, 16)]
    ops.reset_launch_counts()
    y, state = ops.ssd_scan(*args, chunk=16)
    want = ssd_scan_plain(*args, 16)
    torch.testing.assert_close(y, want[0], atol=0, rtol=0)
    torch.testing.assert_close(state, want[1], atol=0, rtol=0)
    assert ops.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                            "pwl_softmax": 0, "cim_matmul": 0}
    with pytest.raises(ValueError):                   # CPU tensors
        ssd_scan_cuda(*args)
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError):
        ops.ssd_scan(*meta, chunk=16)

    # the mamba layer's views of its conv output, rows conv_dim apart: the
    # plain version gives on them what it gives on contiguous copies ...
    b, S, H, P, N = 2, 40, 2, 32, 16
    _, dt, a, _, _ = map(torch.from_numpy, _ssd_inputs(3, b, S, H, P, N))
    conv = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (b, S, H * P + 2 * N)).astype(np.float32))

    def views(t):
        return (t[..., :H * P].reshape(b, S, H, P), t[..., H * P:H * P + N],
                t[..., H * P + N:])

    xv, Bv, Cv = views(conv)
    assert not xv.is_contiguous() and not Bv.is_contiguous()
    got = ops.ssd_scan(xv, dt, a, Bv, Cv, chunk=16)
    want = ops.ssd_scan(xv.contiguous(), dt, a, Bv.contiguous(), Cv.contiguous(), chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    # ... and the kernel reads such bf16 views where they lie, with their
    # row stride, while float32 (contiguous rows only) is copied
    xb, Bb, Cb = views(conv.to(torch.bfloat16))
    kx, kB, kC, xs, bs = kernel_layout(xb, Bb, Cb)
    assert (kx.data_ptr(), kB.data_ptr(), kC.data_ptr()) == \
        (xb.data_ptr(), Bb.data_ptr(), Cb.data_ptr())
    assert xs == bs == H * P + 2 * N
    kx, kB, kC, xs, bs = kernel_layout(xv, Bv, Cv)
    assert kx.is_contiguous() and kB.is_contiguous() and (xs, bs) == (H * P, N)
    with pytest.raises(ValueError):                   # a row is not contiguous
        kernel_layout(xb.transpose(2, 3), Bb, Cb)
    with pytest.raises(ValueError):
        kernel_layout(xb, Bb, conv.to(torch.bfloat16)[..., H * P:H * P + 2 * N:2])


# ---------------------------------------------------------------------------
# Mamba2 sublayers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba_setup():
    jcfg, tcfg = _cfgs("mamba2-2.7b")
    jp = jssm.init_mamba(jcfg, jax.random.PRNGKey(4))
    # non-trivial A, dt bias, skip and norm scale, on both sides
    rng = np.random.default_rng(4)
    H, di = jssm.n_ssm_heads(jcfg), jssm.d_inner_of(jcfg)
    jp = {**jp, "a_log": jnp.asarray(0.3 * rng.standard_normal(H), jnp.float32),
          "dt_bias": jnp.asarray(0.2 * rng.standard_normal(H), jnp.float32),
          "d_skip": jnp.asarray(1 + 0.1 * rng.standard_normal(H), jnp.float32),
          "norm_scale": jnp.asarray(0.1 * rng.standard_normal(di), jnp.float32),
          "conv_b": jnp.asarray(0.1 * rng.standard_normal(jssm.conv_dim_of(jcfg)),
                                jnp.float32)}
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_init_mamba_mirrors_the_jax_keys(mamba_setup):
    jcfg, tcfg, jp, _ = mamba_setup
    tp = tssm.init_mamba(tcfg, torch.Generator().manual_seed(0), n_stack=3)
    assert tp.keys() == jp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (3,) + v.shape
        assert tp[k].dtype == torch.float32
    assert (tp["a_log"] == 0).all() and (tp["d_skip"] == 1).all()


def test_causal_conv_matches_jax(mamba_setup):
    jcfg, _, jp, tp = mamba_setup
    x = np.random.default_rng(5).standard_normal(
        (2, 11, jssm.conv_dim_of(jcfg))).astype(np.float32)
    W = jcfg.ssm.conv_width
    np.testing.assert_allclose(
        tssm._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"], W).numpy(),
        _np(jssm._causal_conv(x, jp["conv_w"], jp["conv_b"], W)), atol=1e-5)


@pytest.mark.parametrize("S", [2, 45])         # S < W - 1 pads the conv state
def test_mamba_sublayer_and_its_state_match_jax(mamba_setup, S):
    jcfg, tcfg, jp, tp = mamba_setup
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    jy, (jconv, jstate) = jssm.mamba_sublayer(jcfg, jp, x, return_state=True)
    ty, (tconv, tstate) = tssm.mamba_sublayer(tcfg, tp, torch.from_numpy(x),
                                              return_state=True)
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=ATOL)
    # the conv state is the in_proj output itself: one matmul of d terms
    np.testing.assert_allclose(tconv.numpy(), _np(jconv), atol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), _np(jstate), atol=ATOL)
    np.testing.assert_allclose(
        tssm.mamba_sublayer(tcfg, tp, torch.from_numpy(x)).numpy(), _np(jy), atol=ATOL)


def test_mamba_decode_sublayer_matches_jax_and_updates_in_place(mamba_setup):
    jcfg, tcfg, jp, tp = mamba_setup
    rng = np.random.default_rng(6)
    B, W = 3, jcfg.ssm.conv_width
    conv = rng.standard_normal((B, W - 1, jssm.conv_dim_of(jcfg))).astype(np.float32)
    state = rng.standard_normal((B, jssm.n_ssm_heads(jcfg), jcfg.ssm.head_dim,
                                 jcfg.ssm.d_state)).astype(np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jy, jconv, jstate = jssm.mamba_decode_sublayer(jcfg, jp, x, conv, state)
    tconv, tstate = torch.from_numpy(conv.copy()), torch.from_numpy(state.copy())
    ty, c2, s2 = tssm.mamba_decode_sublayer(tcfg, tp, torch.from_numpy(x),
                                            tconv, tstate)
    assert c2 is tconv and s2 is tstate                       # in place
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=ATOL)
    np.testing.assert_allclose(tconv.numpy(), _np(jconv), atol=1e-5)
    np.testing.assert_allclose(tstate.numpy(), _np(jstate), atol=1e-5)


# ---------------------------------------------------------------------------
# ssm and hybrid models
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x7b", "llama4-maverick-400b-a17b",
                                          "paligemma-3b"])
def test_init_params_and_cache_mirror_the_jax_trees(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda: jmodels.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))
    want = {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    got = dict(_flat(tp))
    assert got.keys() == want.keys()
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert got[k].dtype == torch.float32
    jc = jmodels.init_cache(jcfg, 3, 40)
    tc = tmodels.init_cache(tcfg, 3, 40, device="cpu")
    want = {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jc)}
    got = dict(_flat(tc))
    assert got.keys() == want.keys()
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(leaf.dtype)
        assert not got[k].any()


@pytest.mark.parametrize("arch", ARCHS + ["paligemma-3b"])
def test_forward_and_decode_match_jax(arch):
    """Prefill logits and cache, then 4 greedy decode steps: logits, every
    cache entry and the greedy ids (paligemma without an image prefix:
    the dense stack with its MQA, GeGLU and tied head)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    B, S, kv_max = 2, 37, 48
    toks = rng.integers(0, jcfg.vocab_size, (B, S))
    jl, _, jc = jax.jit(lambda p, t: jmodels.forward(
        jcfg, p, t, collect_cache=True, kv_max=kv_max))(jp, jnp.asarray(toks))
    tl, _, tc = tmodels.forward(tcfg, tp, torch.from_numpy(toks),
                                collect_cache=True, kv_max=kv_max)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)

    def check_cache(n):
        for key, entry in jc.items():
            for name, arr in entry.items():
                got, want = tc[key][name], _np(arr)
                if name in ("k", "v"):
                    got, want = got[:, :, :n], want[:, :, :n]
                np.testing.assert_allclose(got.numpy(), want, atol=ATOL,
                                           err_msg=f"{key}/{name}")
    check_cache(S)
    step = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    tok = np.array(jnp.argmax(jl[:, -1:], axis=-1))
    assert np.array_equal(tok, tl[:, -1:].argmax(-1).numpy())
    for i in range(4):
        n = S + i + 1
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(n))
        tl, tc = tmodels.decode_step(tcfg, tp, torch.from_numpy(tok), tc, n)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL)
        check_cache(n)
        tok = np.array(jnp.argmax(jl, axis=-1))
        assert np.array_equal(tok, tl.argmax(-1).numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last token, the check
    of tests/test_models.py:test_decode_matches_forward, on the port."""
    _, tcfg = _cfgs(arch)
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 24)))
    full, _, _ = tmodels.forward(tcfg, tp, toks)
    _, _, cache = tmodels.forward(tcfg, tp, toks[:, :23], collect_cache=True, kv_max=28)
    lg, _ = tmodels.decode_step(tcfg, tp, toks[:, 23:], cache, 24)
    err = (lg[:, 0] - full[:, -1]).abs().max().item()
    assert err / full[:, -1].abs().max().item() < 1e-3


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b",
                                  "whisper-large-v3", "paligemma-3b"])
def test_server_matches_the_jax_server_loop(arch):
    """For an SSM every admission step also advances the recurrent state
    of every other slot, in both packages (ROADMAP hazard 6).  mixtral's
    window is cut to 8 so that it binds within the loop's 29 rows.  Neither
    Server runs whisper's encoder: both attend over a zero cross cache
    (hazard 6), with the positions of the shared cur_len; neither gives
    paligemma an image prefix: both admit its prompts as text."""
    jcfg, tcfg = _cfgs(arch, **({"sliding_window": 8} if arch == "mixtral-8x7b" else {}))
    jp, tp = _params(jcfg, seed=3)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n) for n in (6, 3, 9)]
    max_batch, max_len, rounds = 4, 48, 6
    want, want_tokens, want_len = _jax_server_loop(jcfg, jp, prompts,
                                                   max_batch, max_len, rounds)
    srv = tserve.Server(tcfg, max_batch=max_batch, max_len=max_len, device="cpu")
    srv.params = tp
    for rid, p in enumerate(prompts):
        assert srv.admit(rid, p)
    for _ in range(rounds):
        srv.decode_round()
    assert srv.cur_len == want_len
    assert [s.generated for s in srv.slots[:len(prompts)]] == want
    np.testing.assert_array_equal(srv.tokens.numpy(), want_tokens)


def test_serve_cli_runs_the_ssm_on_the_cpu(capsys):
    tserve.main(["--arch", "mamba2-2.7b", "--smoke", "--n-requests", "2",
                 "--max-new", "3", "--max-len", "32", "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")
