"""The body of the captured train step (``launch.steps.make_train_body``,
what ``CompiledTrainStep`` captures as one CUDA graph) on the CPU.

The body updates its params and optimizer state in place, keeps the step
counter on the device and draws the RRAM weight noise from a generator
the caller seeds with ``noise_seed(step)``.  Here it runs eagerly, in
float32 at smoke sizes, and is held bit for bit to the eager
``make_train_step`` (six families with AdamW, maverick with Adafactor,
remat on and off), to the reference's ``jax.jit(make_train_step,
donate_argnums=(0, 1))`` for the dense family (each step's metrics,
gradients and updates within ``tests/test_torch_train.py``'s bounds), and
run under a dispatch mode that fails on any host read of a tensor's
value.  The capture and replay themselves need the card
(``tests/test_torch_gpu.py``).  At step 0 the warmup LR is exactly 0, so
the weights first move at step 1: the runs take 3 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro import optim as joptim
from repro.launch import steps as jsteps
import repro_torch.configs as tconfigs
from repro_torch.checks import graph_vs_eager
from repro_torch.data import PackedStream
from repro_torch.launch import steps as tsteps
from repro_torch.params import from_jax
from repro_torch.tree import tree_map, tree_paths
from test_torch_compiled_step import _NoHostRead
from test_torch_train import GRAD_RTOL, METRIC_RTOL, UPDATE_RTOL, _rel

FAMILIES = ["llama3.2-1b", "whisper-large-v3", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b",
            "paligemma-3b"]
ADAFACTOR_ARCH = "llama4-maverick-400b-a17b"
B, S, STEPS = 2, 32, 3
NOISE_STD = 0.05
HYPER = dict(warmup=1, total_steps=10)


def _cfg(arch, **kw):
    return dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32", **kw)


def _batches(cfg, n, seq=S):
    """``n`` numpy batches of B x seq tokens from PackedStream(0), with
    random frame embeddings (an encoder-decoder) or patch embeddings (a
    VLM) of N(0, 0.02^2)."""
    stream = PackedStream(cfg.vocab_size, seq, seed=0)
    out = []
    for i in range(n):
        b = stream.next_batch(B)
        rows = {"encoder_embeds": cfg.encoder_seq if cfg.is_encoder_decoder else 0,
                "prefix_embeds": cfg.n_prefix_tokens}
        for name, r in rows.items():
            if r:
                b[name] = np.random.default_rng(100 * i + r).normal(
                    size=(B, r, cfg.d_model)).astype(np.float32) * 0.02
        out.append(b)
    return out


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["tokens"], out["labels"] = out["tokens"].long(), out["labels"].long()
    return out


def _state(cfg, seed=0):
    return tsteps.init_train_state(cfg, torch.Generator().manual_seed(seed))


def _clone(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(t.requires_grad), tree)


def _body_generator(step):
    return torch.Generator().manual_seed(tsteps.noise_seed(step))


CASES = [(arch, remat) for arch in FAMILIES for remat in (False, True)] \
    + [(ADAFACTOR_ARCH, False), (ADAFACTOR_ARCH, True)]


@pytest.mark.parametrize("arch,remat", CASES)
def test_body_is_bit_equal_to_the_eager_step_and_updates_in_place(arch, remat):
    """3 steps of the body against 3 of ``make_train_step`` from the same
    state and batches: every metric, param and state leaf bit-equal, the
    RRAM weight noise on under remat (the body's factors from the seeded
    generator, the eager step's drawn for the state's step).  The body
    returns nothing new: the params and state are the tensors it was
    given, at their addresses.  Under remat the forward and its recompute
    draw no random number (the global generator is left as it was): the
    RNG state that the checkpointed groups stash and restore, which a
    capture also records, moves no value."""
    cfg = _cfg(arch, remat=remat)
    noise = NOISE_STD if remat else 0.0
    params, state = _state(cfg)
    ep, es = _clone(params), _clone(state)
    eager = tsteps.make_train_step(cfg, weight_noise_std=noise, **HYPER)
    body = tsteps.make_train_body(cfg, weight_noise_std=noise, **HYPER)
    addresses = tsteps.tensor_addresses(params, state)
    rng = torch.get_rng_state()
    for i, b in enumerate(_batches(cfg, STEPS)):
        ep, es, em = eager(ep, es, _torch_batch(b))
        bm = body(params, state, _torch_batch(b), _body_generator(i))
        for k in em:
            assert torch.equal(em[k], bm[k]), (i, k, float(em[k]), float(bm[k]))
    assert torch.equal(torch.get_rng_state(), rng)
    assert tsteps.tensor_addresses(params, state) == addresses
    assert int(state["step"]) == STEPS and state["step"].dtype == torch.int32
    assert all(p.requires_grad and p.is_leaf for _, p in tree_paths(params))
    got = dict(tree_paths({"p": params, "s": state}))
    for path, t in tree_paths({"p": ep, "s": es}):
        assert torch.equal(got[path], t), path
    moved = sum(not torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_paths(params), tree_paths(_state(cfg)[0])))
    assert moved > 0


def _np_copy(tree):
    """{path: numpy copy} of a tree of tensors or JAX arrays (a copy: a
    donated JAX buffer is reused by the step)."""
    return {path: np.array(leaf.detach() if isinstance(leaf, torch.Tensor) else leaf,
                           copy=True) for path, leaf in tree_paths(tree)}


def test_body_matches_jax_donated_jitted_step():
    """The dense family: 3 steps of the body against the reference's
    ``jax.jit(make_train_step, donate_argnums=(0, 1))`` (no sharding
    context, ROADMAP hazard 1) from the same weights and batches.  Before
    each step both take the loss's gradient at the same params: every
    leaf's within GRAD_RTOL; then each step's metrics within METRIC_RTOL
    and each leaf's update within UPDATE_RTOL (step 0 moves no weight)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("llama3.2-1b"), dtype="float32")
    tcfg = _cfg("llama3.2-1b")
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(0))
    jstate = joptim.make_optimizer("adamw")[0](jp)
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    tstate = tsteps.init_train_state(tcfg, torch.Generator())[1]
    jstep = jax.jit(jsteps.make_train_step(jcfg, **HYPER), donate_argnums=(0, 1))
    jgrad = jax.jit(jax.grad(lambda p, b: jsteps.make_loss_fn(jcfg)(p, b)[0]))
    body = tsteps.make_train_body(tcfg, **HYPER)
    loss_fn = tsteps.make_loss_fn(tcfg)
    for step, b in enumerate(_batches(tcfg, STEPS, seq=64)):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = _torch_batch(b)
        jg = _np_copy(jgrad(jp, jb))
        paths, leaves = zip(*tree_paths(tp))
        tg = torch.autograd.grad(loss_fn(tp, tb)[0], leaves)
        for path, g in zip(paths, tg):
            assert _rel(g.numpy(), jg[path]) <= GRAD_RTOL, (step, path)
        before_j, before_t = _np_copy(jp), _np_copy(tp)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tm = body(tp, tstate, tb)
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL,
                                       atol=1e-12, err_msg=f"step {step} {k}")
        after_j, after_t = _np_copy(jp), _np_copy(tp)
        assert set(after_j) == set(after_t)
        for path in after_j:
            du_j, du_t = after_j[path] - before_j[path], after_t[path] - before_t[path]
            if step == 0:                     # lr is exactly 0 at step 0
                assert not du_j.any() and not du_t.any(), path
            else:
                assert _rel(du_t, du_j) <= UPDATE_RTOL, (step, path, _rel(du_t, du_j))
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_body_reads_nothing_on_the_host(arch, optimizer):
    """One step of the body with the weight noise off and one with it on,
    under remat, inside a dispatch mode that fails on any host read of a
    tensor's value (``.item()``, ``int(t)``, ``bool(t)``): nothing in the
    step that a graph captures waits for the card."""
    cfg = _cfg(arch, remat=True, optimizer=optimizer)
    params, state = _state(cfg, seed=1)
    b = _torch_batch(_batches(cfg, 1)[0])
    bodies = [(tsteps.make_train_body(cfg, weight_noise_std=std, **HYPER), std)
              for std in (0.0, NOISE_STD)]
    with _NoHostRead():
        for body, std in bodies:
            m = body(params, state, b, _body_generator(0) if std else None)
    assert int(state["step"]) == 2
    assert all(t.dim() == 0 for t in m.values())


def test_body_with_noise_needs_its_generator():
    cfg = _cfg("llama3.2-1b")
    params, state = _state(cfg)
    body = tsteps.make_train_body(cfg, weight_noise_std=NOISE_STD, **HYPER)
    with pytest.raises(ValueError, match="generator"):
        body(params, state, _torch_batch(_batches(cfg, 1)[0]))
    assert int(state["step"]) == 0


def test_weight_noise_from_a_seeded_generator_equals_the_steps_draw():
    cfg = _cfg("mixtral-8x7b")
    params, _ = _state(cfg)
    for step in (0, 1, 7):
        a = tsteps.weight_noise(params, NOISE_STD, step)
        b = tsteps.weight_noise(params, NOISE_STD, generator=_body_generator(step))
        for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
            assert (x is None and y is None) or torch.equal(x, y), path


def test_compiled_train_step_needs_a_card():
    cfg = _cfg("llama3.2-1b")
    params, state = _state(cfg)
    with pytest.raises(ValueError, match="CUDA"):
        tsteps.CompiledTrainStep(cfg, params, state, **HYPER)
    with pytest.raises(ValueError, match="CUDA"):
        tsteps.CompiledTrainStep(cfg, params, state, weight_noise_std=NOISE_STD, **HYPER)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_donated_optimizer_update_is_bit_equal_to_the_new_tensors(optimizer):
    """``donate=True`` writes the very bits of the returned new tensors
    into the given params and state, float32 and bf16, with AdamW's leaves
    sliced (a leaf above SLICE_ELEMENTS) or whole."""
    from repro_torch import optim as toptim
    from repro_torch.optim import adamw
    init, update = toptim.make_optimizer(optimizer)
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 8, 16), "b": {"x": (16,)}, "s": (5, 4)}
    for dtype in (torch.float32, torch.bfloat16):
        params = tree_map(lambda s: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dtype), shapes)
        state = init(params)
        dp, ds = _clone(params), _clone(state)
        old = adamw.SLICE_ELEMENTS
        adamw.SLICE_ELEMENTS = 100 if dtype == torch.float32 else old
        try:
            for i in range(3):
                grads = tree_map(lambda p: torch.from_numpy((0.1 * rng.standard_normal(
                    tuple(p.shape))).astype(np.float32)).to(dtype), params)
                params, state = update(params, grads, state, lr=torch.tensor(1e-2))
                out = update(dp, _clone(grads), ds, lr=torch.tensor(1e-2), donate=True)
                assert out[0] is dp and out[1] is ds
        finally:
            adamw.SLICE_ELEMENTS = old
        donated = dict(tree_paths({"p": dp, "s": ds}))
        for path, t in tree_paths({"p": params, "s": state}):
            assert torch.equal(donated[path], t), path
        assert int(ds["step"]) == 3


def test_graph_vs_eager_rule():
    """Bit-equal where the two eager runs are; within twice their spread
    (relative) where they are not; a float metric and a tensor leaf alike."""
    def run(dl=0.0, du=0.0):
        return [{"loss": 2.0 + dl, "w": torch.arange(4.0) + du, "b": torch.ones(2)}]

    eager = run()
    assert graph_vs_eager(run(), eager, run()) == (set(), 0.0, [])
    spread, worst, bad = graph_vs_eager(run(1e-6), eager, run())
    assert spread == set() and [b[1] for b in bad] == ["loss"]
    spread, worst, bad = graph_vs_eager(run(2e-6, 1e-6), eager, run(1e-6, 1e-6))
    assert spread == {"loss", "w"} and not bad and 0.5 < worst <= 1.0
    spread, worst, bad = graph_vs_eager(run(5e-6), eager, run(1e-6))
    assert spread == {"loss"} and [b[1] for b in bad] == ["loss"] and worst > 2
