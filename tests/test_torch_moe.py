"""The port's MoE block and moe family (mixtral-8x7b, llama4-maverick)
against the JAX package, on the CPU in float32.

Both packages get the same weights (the JAX init, carried over with
``repro_torch.params.from_jax``) and the same numpy inputs.  The JAX side
is built from bare ``moe_sublayer`` / ``forward`` / ``decode_step`` /
step functions, jitted without a sharding context (ROADMAP hazard 1).
The smoke mixtral has a window of 64, 4 experts, top-2 and head_dim 32;
the smoke maverick top-1 with one shared expert, every 2nd layer MoE.
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
from repro.models import moe as jmoe
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.params import from_jax
from test_torch_compiled_step import _NoHostRead

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
# float32 on both sides: y sums d_ff_expert products in another order, and
# with the JAX init (expert fan-in taken from the expert axis, E**-0.5) its
# values reach the hundreds, so y is held within Y_RTOL of its max |value|;
# the models a few layers with logits of order 1; aux a mean of softmax
# probabilities, the same float32 steps in another order
Y_RTOL = 1e-5
ATOL = 1e-4
AUX_RTOL = 1e-6


def _cfgs(arch, **kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32", **kw)
    return j, t


def _params(jcfg, seed=0):
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _moe_setup(arch, cf=None, seed=0):
    moe = {} if cf is None else {"moe": dataclasses.replace(
        jconfigs.get_smoke_config(arch).moe, capacity_factor=cf)}
    jcfg, tcfg = _cfgs(arch, **moe)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _dropped(jcfg, jp, x):
    """How many of the (token, choice) pairs the dispatch drops: per batch
    row and expert, the choices past the capacity."""
    m = jcfg.moe
    logits = np.asarray(x, np.float32) @ np.asarray(jp["router"])
    idx = np.argsort(-logits, axis=-1)[..., :m.top_k]               # (B, S, k)
    C = jmoe._capacity(x.shape[1], m.n_experts, m.top_k, m.capacity_factor)
    counts = np.stack([np.bincount(r.reshape(-1), minlength=m.n_experts) for r in idx])
    return int(np.clip(counts - C, 0, None).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,cf", [(2, 40, 0.5), (3, 50, None), (1, 20, None), (4, 1, None)])
def test_moe_sublayer_matches_jax(arch, B, S, cf):
    """The dispatch path (B * S > 32) with capacity factor 0.5, so that
    choices are dropped, and at the config's 1.25; the dense path (B * S <=
    32, a decode step at B 4): y and the aux loss."""
    jcfg, tcfg, jp, tp = _moe_setup(arch, cf)
    x = np.random.default_rng(B * S).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if cf is not None:
        assert B * S > tmoe.DENSE_TOKEN_THRESHOLD and _dropped(jcfg, jp, x) > 0
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_sublayer(jcfg, p, x))(jp, x)
    ty, taux = tmoe.moe_sublayer(tcfg, tp, torch.from_numpy(x))
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy),
                               atol=Y_RTOL * float(np.abs(np.asarray(jy)).max()))
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=AUX_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_bf16_dense_and_dispatch_paths_agree_with_jax(arch):
    """bfloat16, as the card serves: the same 32 tokens through the dense
    path (B * S = 32) and through the dispatch path (33 tokens, capacity
    E / k so that nothing is dropped), in both packages.  Each product is
    rounded to bfloat16 at other places in each (the activation, the gate
    weighting, the sum over experts), so every pair is held to
    2**-7 |want| + 2**-8 max |want| an element: a bf16 step of the element
    and half of one of the largest."""
    base = jconfigs.get_smoke_config(arch)
    moe = dataclasses.replace(base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k)
    jcfg = dataclasses.replace(base, dtype="bfloat16", moe=moe)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="bfloat16", moe=moe)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(0).standard_normal((1, 33, jcfg.d_model)).astype(np.float32)
    jfn = jax.jit(lambda p, x: jmoe.moe_sublayer(jcfg, p, x))
    ys = {}
    for n in (32, 33):
        jy, _ = jfn(jp, jnp.asarray(x[:, :n], jnp.bfloat16))
        ty, _ = tmoe.moe_sublayer(tcfg, tp, torch.from_numpy(x[:, :n]).bfloat16())
        assert ty.dtype == torch.bfloat16
        ys["jax", n] = np.asarray(jy.astype(jnp.float32))[:, :32]
        ys["port", n] = ty.float().numpy()[:, :32]
    top = float(np.abs(ys["jax", 32]).max())
    for got, want in ((("port", 32), ("jax", 32)), (("port", 33), ("jax", 33)),
                      (("port", 32), ("port", 33)), (("jax", 32), ("jax", 33))):
        diff = np.abs(ys[got] - ys[want])
        assert (diff <= 2 ** -7 * np.abs(ys[want]) + 2 ** -8 * top).all(), (got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_mirrors_the_jax_tree(arch):
    jcfg, tcfg, jp, _ = _moe_setup(arch)
    tp = tmoe.init_moe(tcfg, torch.Generator().manual_seed(0))
    want = {k: v for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    got = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                got[path + (k,)] = v
    walk(tp, ())
    assert got.keys() == {tuple(p.key for p in path) for path in want}
    for path, leaf in want.items():
        t = got[tuple(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype)
    assert ("shared" in tp) == (tcfg.moe.n_shared_experts > 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_sublayer_reads_nothing_on_the_host(arch):
    """Both paths, under a dispatch mode that fails on any host read of a
    tensor value (no boolean-mask indexing, no ``.item()``), so the block
    can be captured in a CUDA graph; the dispatch path with drops."""
    _, tcfg, _, tp = _moe_setup(arch, 0.5)
    for B, S in ((2, 40), (4, 1)):
        x = torch.randn((B, S, tcfg.d_model), generator=torch.Generator().manual_seed(S))
        with _NoHostRead():
            y, aux = tmoe.moe_sublayer(tcfg, tp, x)
        assert y.shape == x.shape and aux.shape == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_group_layout_matches_jax(arch):
    """mixtral: one MoE block a group; maverick: a dense and a MoE block a
    group (moe_every 2), at smoke and at full size.  The params and cache
    trees are held by tests/test_torch_ssm.py's tree test."""
    jcfg, tcfg = _cfgs(arch)
    assert tmodels.group_layout(tcfg) == jmodels.group_layout(jcfg)
    full = tconfigs.get_config(arch)
    assert tmodels.group_layout(full) == jmodels.group_layout(jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_past_the_window_match_jax(arch):
    """Prefill of 100 tokens (mixtral's window of 64 binds), logits within
    ATOL and the aux loss within AUX_RTOL; then 8 greedy decode steps, every
    one past the window: logits and ids equal to JAX's jitted step."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    B, S, kv_max = 2, 100, 112
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    jl, jaux, jc = jax.jit(lambda p, t: jmodels.forward(
        jcfg, p, t, collect_cache=True, kv_max=kv_max))(jp, jnp.asarray(toks))
    tl, taux, tc = tmodels.forward(tcfg, tp, torch.from_numpy(toks), collect_cache=True,
                                   kv_max=kv_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=AUX_RTOL)
    assert taux.item() > 0
    step = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    tok = np.array(jnp.argmax(jl[:, -1:], axis=-1))
    assert np.array_equal(tok, tl[:, -1:].argmax(-1).numpy())
    for i in range(8):
        n = S + i + 1
        jl, jc = step(jp, jnp.asarray(tok), jc, jnp.int32(n))
        tl, tc = tmodels.decode_step(tcfg, tp, torch.from_numpy(tok), tc, n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        tok = np.array(jnp.argmax(jl, axis=-1))
        assert np.array_equal(tok, tl.argmax(-1).numpy()), f"step {i}"


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_give_the_jax_greedy_ids(arch):
    """make_prefill_step, then 8 make_serve_step steps past the window, on
    both sides: the greedy ids at every step."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=2)
    B, S, max_len = 2, 70, 80
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S))
    jtok, jc = jax.jit(jsteps.make_prefill_step(jcfg, kv_max=max_len))(
        jp, {"tokens": jnp.asarray(toks)})
    ttok, tc = tsteps.make_prefill_step(tcfg, kv_max=max_len)(
        tp, {"tokens": torch.from_numpy(toks)})
    jserve, tserve_step = jax.jit(jsteps.make_serve_step(jcfg)), tsteps.make_serve_step(tcfg)
    for i in range(8):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")
        jtok, jc = jserve(jp, jc, jtok, jnp.int32(S + i + 1))
        ttok, tc = tserve_step(tp, tc, ttok, S + i + 1)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_prefill(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last token, with the
    window binding at S 90.  As in tests/test_models.py, with a capacity
    factor of 8 that drops no choice: the forward's dispatch drops the last
    tokens' choices first, the decode step's dense path none."""
    _, tcfg = _cfgs(arch, moe=dataclasses.replace(
        tconfigs.get_smoke_config(arch).moe, capacity_factor=8.0))
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 90)))
    full, _, _ = tmodels.forward(tcfg, tp, toks)
    _, _, cache = tmodels.forward(tcfg, tp, toks[:, :89], collect_cache=True, kv_max=96)
    lg, _ = tmodels.decode_step(tcfg, tp, toks[:, 89:], cache, 90)
    err = (lg[:, 0] - full[:, -1]).abs().max().item()
    assert err / full[:, -1].abs().max().item() < 1e-3


def test_serve_cli_runs_mixtral_on_the_cpu(capsys):
    tserve.main(["--arch", "mixtral-8x7b", "--smoke", "--n-requests", "2",
                 "--max-new", "3", "--max-len", "32", "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")
