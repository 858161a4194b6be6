"""The port's training path (repro_torch.launch.steps / optim) against the
JAX package's, on the CPU in float32.

Both packages start from the same weights (the JAX init through
``repro_torch.params.from_jax``) and see the same numpy batches.  The
reference step is ``jax.jit(repro.launch.steps.make_train_step(cfg))``
built without a sharding context (ROADMAP hazard 1).  At step 0 the
warmup LR is exactly 0, so the parameters first move at step 1: the
parity runs 3 steps.
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
from repro.models import common as jcommon
from repro import optim as joptim
import repro_torch.configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch import optim as toptim
from repro_torch.tree import tree_from_paths, tree_paths
from repro_torch.data import PackedStream
from repro_torch.params import from_jax

ARCH = "llama3.2-1b"
B, S, STEPS = 2, 64, 3
# metrics per step: float32 on both sides, the same math in another
# summation order through a 2-layer smoke model (~3e-7 apart)
METRIC_RTOL = 1e-5
# each leaf's update p_after - p_before against JAX's, relative L2 norm:
# AdamW's m / (sqrt(v) + eps) and Adafactor's g / sqrt(v) divide the
# float32 rounding of gradients near 0 by their own small size
UPDATE_RTOL = 1e-3
# the optimizer, clip and schedule functions alone on the same inputs
FN_RTOL = 1e-6


def _cfgs(**kw):
    j = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    t = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32", **kw)
    return j, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, n, seed=0, seq=S):
    stream = PackedStream(cfg.vocab_size, seq, seed=seed)
    return [stream.next_batch(B) for _ in range(n)]


def _torch_batch(b):
    return {"tokens": torch.from_numpy(b["tokens"]).long(),
            "labels": torch.from_numpy(b["labels"]).long(),
            "mask": torch.from_numpy(b["mask"])}


def _flat(tree):
    """{path: numpy array} of a nested dict of arrays or tensors."""
    return {path: (np.asarray(leaf.detach()) if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf)) for path, leaf in tree_paths(tree)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run_both(optimizer, *, steps=STEPS, noise_std=0.0):
    jcfg, tcfg = _cfgs(optimizer=optimizer)
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    jopt_init, _ = joptim.make_optimizer(optimizer)
    jstate = jopt_init(jp)
    tp = from_jax(_np_tree(jp), "cpu")
    topt_init, _ = toptim.make_optimizer(optimizer)
    tstate = topt_init(tp)
    jstep = jax.jit(jsteps.make_train_step(jcfg, warmup=1, total_steps=10,
                                           weight_noise_std=noise_std))
    tstep = tsteps.make_train_step(tcfg, warmup=1, total_steps=10,
                                   weight_noise_std=noise_std)
    out = []
    for i, b in enumerate(_batches(jcfg, steps)):
        noise = None
        if noise_std:
            noise = from_jax(_np_tree(_jax_noise(jp, noise_std, i)), "cpu")
        before_j, before_t = _flat(jp), _flat(tp)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tp, tstate, tm = tstep(tp, tstate, _torch_batch(b), noise=noise)
        out.append((before_j, _flat(jp), before_t, _flat(tp),
                    {k: float(v) for k, v in jm.items()},
                    {k: float(v) for k, v in tm.items()}))
    return out


def _jax_noise(params, std, step):
    """The factors ``1 + std * normal`` that the reference's loss draws at
    ``step`` (``src/repro/launch/steps.py:36-47``), as a tree of float32."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), jnp.int32(step))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten([
        1 + std * jax.random.normal(k, l.shape, jnp.float32) for l, k in zip(leaves, keys)])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_matches_jax(optimizer):
    for step, (bj, aj, bt, at, jm, tm) in enumerate(_run_both(optimizer)):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL, atol=1e-12,
                                       err_msg=f"step {step} {k}")
        assert set(at) == set(aj)
        for path in aj:
            if step == 0:
                np.testing.assert_array_equal(bt[path], bj[path])
            du_j, du_t = aj[path] - bj[path], at[path] - bt[path]
            if step == 0:                     # lr is exactly 0 at step 0
                assert not du_j.any() and not du_t.any(), path
            else:
                assert _rel(du_t, du_j) <= UPDATE_RTOL, (step, path, _rel(du_t, du_j))


def test_weight_noise_loss_with_jax_factors_matches_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = from_jax(_np_tree(jp), "cpu")
    b = _batches(jcfg, 1)[0]
    jloss = jsteps.make_loss_fn(jcfg, weight_noise_std=0.05)
    tloss = tsteps.make_loss_fn(tcfg, weight_noise_std=0.05)
    for step in (0, 3):
        key = jax.random.fold_in(jax.random.PRNGKey(17), jnp.int32(step))
        jl, _ = jax.jit(jloss)(jp, {k: jnp.asarray(v) for k, v in b.items()}, key)
        noise = from_jax(_np_tree(_jax_noise(jp, 0.05, step)), "cpu")
        tl, _ = tloss(tp, _torch_batch(b), noise=noise)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        clean, _ = tloss(tp, _torch_batch(b))
        assert abs(float(clean) - float(tl)) > 1e-4         # the noise moved it
    # the port's own draws: one generator per step, the same on a rerun
    a = tsteps.weight_noise(tp, 0.05, 2)
    c = tsteps.weight_noise(tp, 0.05, 2)
    d = tsteps.weight_noise(tp, 0.05, 3)
    wq = ("layers", "b0_dense", "attn", "wq")
    get = lambda t: t["layers"]["b0_dense"]["attn"]["wq"]
    assert torch.equal(get(a), get(c)) and not torch.equal(get(a), get(d))
    assert a["final_norm"]["scale"] is None                  # 1-dim: no noise
    assert abs(float(get(a).std()) - 0.05) < 0.01, wq


def test_train_step_with_weight_noise_matches_jax():
    for step, (bj, aj, bt, at, jm, tm) in enumerate(_run_both("adamw", noise_std=0.05)):
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=METRIC_RTOL, err_msg=f"{step} {k}")


def test_remat_gives_the_same_gradients():
    _, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    params, _ = tsteps.init_train_state(tcfg, gen)
    batch = _torch_batch(_batches(tcfg, 1)[0])
    grads = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, _ = tsteps.make_loss_fn(cfg)(params, batch)
        leaves = [p for _, p in tree_paths(params)]
        grads.append([g.numpy() for g in torch.autograd.grad(loss, leaves)])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


# the families whose training the card runs besides the dense one
FAMILIES = ["whisper-large-v3", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b", "paligemma-3b"]
# each leaf's gradient against JAX's at the same params and batch,
# relative L2 norm: float32 sums in another order through a smoke model
# (whisper's encoder and cross-attention, mamba2's chunked scan, zamba2's
# shared block summed over its applications, mixtral's MoE dispatch,
# paligemma's bidirectional prefix)
GRAD_RTOL = 1e-4


def _family_cfgs(arch, **kw):
    """The smoke config of ``arch`` in float32 on both sides; a hybrid runs
    two groups (two applications of its shared attention block, whose
    gradient sums over both)."""
    cfgs = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_smoke_config(arch)
        if cfg.attn_every:
            kw = {**kw, "n_layers": 2 * cfg.attn_every}
        cfgs.append(dataclasses.replace(cfg, dtype="float32", **kw))
    return cfgs


def _family_batches(cfg, n, seq=S):
    """``n`` numpy batches of B x seq tokens, with the random frame
    embeddings (N(0, 0.02^2), seeded by the step) that the reference's
    ``launch/train.py`` gives an encoder-decoder, and random patch
    embeddings of the same law before a VLM's tokens (the zero prefix of
    ``launch/train.py`` would leave the prefix's keys all 0 in the first
    layer)."""
    out = []
    for i, b in enumerate(_batches(cfg, n, seq=seq)):
        if cfg.is_encoder_decoder:
            b["encoder_embeds"] = np.random.default_rng(i).normal(
                size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.n_prefix_tokens:
            b["prefix_embeds"] = np.random.default_rng(100 + i).normal(
                size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32) * 0.02
        out.append(b)
    return out


def _jax_grads_and_step(jcfg):
    """jit of (the loss's gradient, one train step) of the reference."""
    jloss = jsteps.make_loss_fn(jcfg)
    jstep_fn = jsteps.make_train_step(jcfg, warmup=1, total_steps=10)
    return jax.jit(lambda p, st, b: (jax.grad(lambda q: jloss(q, b)[0])(p), jstep_fn(p, st, b)))


def _port_grads(tcfg, tp, tb):
    """{path: gradient} of the port's loss at params ``tp`` on batch ``tb``."""
    paths, leaves = zip(*tree_paths(tp))
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    params = tree_from_paths(zip(paths, leaves))
    grads = torch.autograd.grad(tsteps.make_loss_fn(tcfg)(params, tb)[0], leaves)
    return {path: g.numpy() for path, g in zip(paths, grads)}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_matches_jax(arch, remat):
    """whisper (the non-causal encoder, the cross-attention, encode's remat),
    mamba2 (the SSD scan's gradient), zamba2 (two groups: the shared
    block's gradient sums over its two applications), mixtral (the MoE
    dispatch; at S 64 its smoke window of 64 does not bind) and paligemma
    (16 prefix rows seen bidirectionally before 64 tokens): 3 AdamW steps
    of the port's train step against ``jax.jit(make_train_step)`` without
    a sharding context, from the same weights and batches.  Before each
    step both take the loss's gradient at the same params: every leaf's
    within GRAD_RTOL; then each step's metrics and each leaf's update."""
    jcfg, tcfg = _family_cfgs(arch, remat=remat)
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    jstate = joptim.make_optimizer("adamw")[0](jp)
    tp = from_jax(_np_tree(jp), "cpu")
    tstate = toptim.adamw_init(tp)
    jboth = _jax_grads_and_step(jcfg)
    tstep = tsteps.make_train_step(tcfg, warmup=1, total_steps=10)
    for step, b in enumerate(_family_batches(tcfg, STEPS)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = _torch_batch(b)
        for key in ("encoder_embeds", "prefix_embeds"):
            if key in b:
                tb[key] = torch.from_numpy(b[key])
        jgrads, (jp_next, jstate, jm) = jboth(jp, jstate, jb)
        tgrads, jflat = _port_grads(tcfg, tp, tb), _flat(jgrads)
        assert set(jflat) == set(tgrads)
        for path, g in tgrads.items():
            assert _rel(g, jflat[path]) <= GRAD_RTOL, (step, path, _rel(g, jflat[path]))
        before_j, before_t = _flat(jp), _flat(tp)
        tp, tstate, tm = tstep(tp, tstate, tb)
        jp = jp_next
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-12,
                                       err_msg=f"step {step} {k}")
        after_j, after_t = _flat(jp), _flat(tp)
        for path in after_j:
            du_j, du_t = after_j[path] - before_j[path], after_t[path] - before_t[path]
            if step == 0:                     # lr is exactly 0 at step 0
                assert not du_j.any() and not du_t.any(), path
            else:
                assert _rel(du_t, du_j) <= UPDATE_RTOL, (step, path, _rel(du_t, du_j))


def test_mixtral_windowed_train_step_gradients_match_jax():
    """mixtral's smoke config at S 128, where its window of 64 binds (and
    the MoE dispatch path runs): 3 AdamW steps of the port's train step
    against the reference's jitted step; before each, every leaf's
    gradient within GRAD_RTOL of JAX's at the same params, and each step's
    metrics within METRIC_RTOL.  The AdamW updates are not held here: at
    S 128 ``embed``'s update after 3 steps lies 1.16e-3 from JAX's,
    relative, past UPDATE_RTOL, as AdamW divides the float32 rounding of
    gradients near 0 by their own small size (ROADMAP hazard 10); the
    gradients it divides agree."""
    jcfg, tcfg = _family_cfgs("mixtral-8x7b")
    assert tcfg.sliding_window == 64
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    jstate = joptim.make_optimizer("adamw")[0](jp)
    tp = from_jax(_np_tree(jp), "cpu")
    tstate = toptim.adamw_init(tp)
    jboth = _jax_grads_and_step(jcfg)
    tstep = tsteps.make_train_step(tcfg, warmup=1, total_steps=10)
    for step, b in enumerate(_family_batches(tcfg, STEPS, seq=128)):
        jgrads, (jp, jstate, jm) = jboth(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tb = _torch_batch(b)
        tgrads, jflat = _port_grads(tcfg, tp, tb), _flat(jgrads)
        assert set(jflat) == set(tgrads)
        for path, g in tgrads.items():
            assert _rel(g, jflat[path]) <= GRAD_RTOL, (step, path, _rel(g, jflat[path]))
        tp, tstate, tm = tstep(tp, tstate, tb)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, atol=1e-12,
                                       err_msg=f"step {step} {k}")


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels).long()
    for m in (None, mask, np.zeros_like(mask)):
        want = float(jsteps.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                          None if m is None else jnp.asarray(m)))
        got = float(tsteps.cross_entropy(tl, tlab, None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _grads_and_params(seed=0):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((3, 8, 16)).astype(np.float32),
         "b": {"x": rng.standard_normal((16,)).astype(np.float32)},
         "s": rng.standard_normal((5, 4)).astype(np.float32)}
    g = jax.tree.map(lambda a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)
    return p, g


def _close_trees(t, j, rtol=FN_RTOL, atol=1e-8):
    tf, jf = _flat(t), _flat(j)
    assert set(tf) == set(jf)
    for path in jf:
        np.testing.assert_allclose(tf[path], jf[path], rtol=rtol, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_jax(name):
    p, g = _grads_and_params()
    jinit, jupd = joptim.make_optimizer(name)
    tinit, tupd = toptim.make_optimizer(name)
    jp, js = jax.tree.map(jnp.asarray, p), jinit(jax.tree.map(jnp.asarray, p))
    tp, ts = from_jax(p, "cpu"), tinit(from_jax(p, "cpu"))
    for i in range(3):
        gi = jax.tree.map(lambda a: a * (i + 1), g)
        jp, js = jax.jit(lambda a, b, c: jupd(a, b, c, lr=jnp.float32(1e-2)))(
            jp, jax.tree.map(jnp.asarray, gi), js)
        tp, ts = tupd(tp, from_jax(gi, "cpu"), ts, lr=torch.tensor(1e-2))
        _close_trees(tp, jp)
        _close_trees({k: v for k, v in ts.items() if k != "step"},
                     {k: v for k, v in js.items() if k != "step"})
        assert int(ts["step"]) == int(js["step"]) == i + 1
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    # bf16 params: float32 math, cast back
    tb = tcommon.cast_tree(from_jax(p, "cpu"), torch.bfloat16)
    nb, _ = tupd(tb, from_jax(g, "cpu"), tinit(tb), lr=1e-2)
    assert all(t.dtype == torch.bfloat16 for _, t in tree_paths(nb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sliced", [False, True])
def test_adamw_update_is_the_formula_bit_for_bit(dtype, sliced):
    """``adamw_update``'s in-place arithmetic gives the bits of the
    reference's formula written out of place, params and moments, over 3
    steps with the LR a float and a 0-dim tensor, exact zeros in the
    gradient, and a leaf updated whole or a slice at a time."""
    from repro_torch.optim import adamw
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal((6, 40, 24)).astype(np.float32)).to(dtype)
    state = toptim.adamw_init({"w": p})
    m, v = state["m"]["w"].clone(), state["v"]["w"].clone()
    old = adamw.SLICE_ELEMENTS
    adamw.SLICE_ELEMENTS = 1000 if sliced else old
    try:
        for i, lr in enumerate((1e-2, torch.tensor(3e-3), torch.tensor(0.0))):
            g = torch.from_numpy((1e-3 * rng.standard_normal(p.shape)).astype(np.float32))
            g[0, :3] = 0.0
            g = g.to(dtype)
            t = torch.tensor(float(i + 1))
            bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
            g32, p32 = g.to(torch.float32), p.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            want = (p32 - lr * (m / bc1 / (torch.sqrt(v / bc2) + eps) + wd * p32)).to(dtype)
            new, state = toptim.adamw_update({"w": p}, {"w": g}, state, lr=lr)
            assert torch.equal(new["w"], want), i
            assert torch.equal(state["m"]["w"], m) and torch.equal(state["v"]["w"], v), i
            p = want
    finally:
        adamw.SLICE_ELEMENTS = old


def test_clip_and_schedule_match_jax():
    _, g = _grads_and_params(1)
    for max_norm in (0.5, 100.0):
        jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tc, tn = toptim.clip_by_global_norm(from_jax(g, "cpu"), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=FN_RTOL)
        _close_trees(tc, jc)
    for step in (0, 1, 5, 9, 10, 11, 57, 99, 100, 250):
        kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
        want = float(joptim.linear_warmup_cosine(jnp.float32(step), **kw))
        got = float(toptim.linear_warmup_cosine(torch.tensor(float(step)), **kw))
        np.testing.assert_allclose(got, want, rtol=FN_RTOL, atol=1e-12)
        want = float(joptim.cosine_schedule(jnp.float32(step), base_lr=1.0, total_steps=100))
        got = float(toptim.cosine_schedule(torch.tensor(float(step)), base_lr=1.0,
                                           total_steps=100))
        np.testing.assert_allclose(got, want, rtol=FN_RTOL, atol=1e-12)
    assert float(toptim.linear_warmup_cosine(torch.tensor(0.0), base_lr=3e-4,
                                             warmup_steps=10, total_steps=20)) == 0.0


def test_tree_utilities_match_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    tp = from_jax(_np_tree(jp), "cpu")
    assert tcommon.count_params(tp) == jcommon.count_params(jp)
    assert tcommon.tree_bytes(tp) == jcommon.tree_bytes(jp)
    tb, jb = tcommon.cast_tree(tp, torch.bfloat16), jcommon.cast_tree(jp, jnp.bfloat16)
    assert tcommon.tree_bytes(tb) == jcommon.tree_bytes(jb)
    mixed = {"w": torch.ones(2, 3), "i": torch.arange(3, dtype=torch.int32)}
    cast = tcommon.cast_tree(mixed, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16 and cast["i"].dtype == torch.int32


def test_init_train_state_and_step_leave_grad_leaves():
    _, tcfg = _cfgs()
    params, state = tsteps.init_train_state(tcfg, torch.Generator().manual_seed(0))
    assert set(state) == {"m", "v", "step"}
    assert all(p.requires_grad and p.is_leaf for _, p in tree_paths(params))
    step = tsteps.make_train_step(tcfg, warmup=1, total_steps=10)
    batch = _torch_batch(_batches(tcfg, 1)[0])
    params, state, m = step(params, state, batch)
    assert all(p.requires_grad and p.is_leaf for _, p in tree_paths(params))
    assert set(m) == {"loss", "ce", "aux", "grad_norm", "lr"}
    assert all(t.dim() == 0 and not t.requires_grad for t in m.values())
    assert int(state["step"]) == 1 and float(m["lr"]) == 0.0
