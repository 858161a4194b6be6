"""The serve step with ``cache_len`` as a device scalar, the form the port's
CUDA graph captures (``launch.steps.CompiledServeStep``), on the CPU.

The JAX package jits its serve step with ``cache_len`` traced
(``repro.launch.serve``); the port's step takes it as a 0-dim tensor and
must read nothing on the host, so that one captured graph serves every
length.  Here that step is held to the JAX jitted step (greedy ids and
logits, float32 smoke configs, the same weights through
``repro_torch.params.from_jax``) and run under a dispatch mode that fails
on any host read of a tensor's value.  The capture and replay themselves
need the card (``tests/test_torch_gpu.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jconfigs
import repro.models as jmodels
from repro.launch import steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.params import from_jax

ARCHS = ["llama3-8b", "mamba2-2.7b", "zamba2-2.7b", "mixtral-8x7b", "whisper-large-v3",
         "paligemma-3b"]
# float32 on both sides, logits of order 1 through a few smoke layers: the
# bar of tests/test_torch_models.py and tests/test_torch_ssm.py
ATOL = 1e-4


def _setup(arch, seed=0):
    """float32 smoke configs of both packages and the same weights; a
    sliding window (mixtral's 64) is cut to 16 so that it binds within the
    tests' 29-35 rows."""
    kw = {"dtype": "float32"}
    if jconfigs.get_smoke_config(arch).sliding_window:
        kw["sliding_window"] = 16
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), **kw)
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, toks, seed=7):
    """The prefill batch: the token ids, and an encoder-decoder's frame
    embeddings (whisper's encoder_seq of them) or a prefix-LM's patch
    embeddings (paligemma's n_prefix_tokens of them) from a numpy seed."""
    batch = {"tokens": toks}
    rows = {"encoder_embeds": cfg.encoder_seq if cfg.is_encoder_decoder else 0,
            "prefix_embeds": cfg.n_prefix_tokens}
    for name, n in rows.items():
        if n:
            batch[name] = np.random.default_rng(seed).standard_normal(
                (toks.shape[0], n, cfg.d_model)).astype(np.float32)
    return batch


def _copy(cache):
    return {k: {n: t.clone() for n, t in e.items()} for k, e in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_with_a_tensor_length_gives_the_jax_jitted_step(arch):
    """Prefill, then 6 greedy steps: the port's serve step given cache_len
    as a 0-dim tensor against the JAX serve step jitted with a traced
    int32: the same ids at every step, logits within ATOL."""
    jcfg, tcfg, jp, tp = _setup(arch)
    B, steps = 2, 6
    S = 29 + jcfg.n_prefix_tokens           # cache rows after the prefill
    max_len = S + 11
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, 29))
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, kv_max=max_len))
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    jdecode = jax.jit(lambda p, t, c, n: jmodels.decode_step(jcfg, p, t, c, n))
    batch = _batch(jcfg, toks)
    jtok, jc = jprefill(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    ttok, tc = tsteps.make_prefill_step(tcfg, kv_max=max_len)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    serve = tsteps.make_serve_step(tcfg)
    for i in range(steps):
        n = S + i + 1
        jl, _ = jdecode(jp, jtok, jc, jnp.int32(n))
        tl, _ = tmodels.decode_step(tcfg, tp, ttok, _copy(tc), torch.tensor(n))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        jtok, jc = jserve(jp, jc, jtok, jnp.int32(n))
        ttok, tc = serve(tp, tc, ttok, torch.tensor(n))
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok), err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_and_int_lengths_give_the_same_bits(arch):
    """decode_step with cache_len as an int and as a 0-dim tensor: equal
    logits and caches, bit for bit."""
    _, tcfg, _, _ = _setup(arch)
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(1))
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, 12))
    enc = {k: torch.from_numpy(v) for k, v in _batch(tcfg, toks).items() if k != "tokens"}
    toks = torch.from_numpy(toks)
    P = tcfg.n_prefix_tokens
    _, _, cache = tmodels.forward(tcfg, tp, toks[:, :9], collect_cache=True, kv_max=16 + P,
                                  **enc)
    by_int, by_tensor = _copy(cache), _copy(cache)
    for i in range(9, 12):
        li, _ = tmodels.decode_step(tcfg, tp, toks[:, i:i + 1], by_int, P + i + 1)
        lt, _ = tmodels.decode_step(tcfg, tp, toks[:, i:i + 1], by_tensor,
                                    torch.tensor(P + i + 1, dtype=torch.int32))
        assert torch.equal(li, lt)
    for key, entry in by_int.items():
        for name, t in entry.items():
            assert torch.equal(t, by_tensor[key][name]), f"{key}/{name}"


class _NoHostRead(TorchDispatchMode):
    """Fails on ``aten._local_scalar_dense`` (``.item()``, ``int(t)``,
    ``bool(t)``: a value brought to the host) unless ``allowed``."""

    def __init__(self):
        super().__init__()
        self.allowed = False
        self.exempt_calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default and not self.allowed:
            raise AssertionError("host read of a tensor value")
        return func(*args, **(kwargs or {}))


def test_the_host_read_guard_catches_a_read():
    with _NoHostRead(), pytest.raises(AssertionError, match="host read"):
        int(torch.tensor(3) + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_with_a_tensor_length_reads_nothing_on_the_host(arch, monkeypatch):
    """The step a CUDA graph captures makes no host read.  Only the plain
    paged attention may (it bounds its loop by ``context_lens.max()``): it
    is the CPU's stand-in for the kernel and never runs on the card."""
    _, tcfg, _, _ = _setup(arch)
    tp = tmodels.init_params(tcfg, torch.Generator().manual_seed(2))
    cache = tmodels.init_cache(tcfg, 2, 16, device="cpu")
    guard = _NoHostRead()
    plain = ops._pa.paged_attention_plain

    def exempt(*args, **kwargs):
        guard.allowed, guard.exempt_calls = True, guard.exempt_calls + 1
        try:
            return plain(*args, **kwargs)
        finally:
            guard.allowed = False

    monkeypatch.setattr(ops._pa, "paged_attention_plain", exempt)
    serve = tsteps.make_serve_step(tcfg)
    tok = torch.tensor([[3], [5]])
    with guard:
        for n in (1, 2, 3):
            tok, cache = serve(tp, cache, tok, torch.tensor(n))
    kinds, n_groups = tmodels.group_layout(tcfg)
    # one paged call per attention block, two per decoder block (self, cross)
    n_paged = sum({"mamba": 0, "dec": 2}.get(k, 1) for k in kinds) * n_groups
    assert guard.exempt_calls == 3 * n_paged
    assert tok.shape == (2, 1)


def test_compiled_step_needs_a_card_and_the_cpu_server_stays_eager():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("llama3-8b"), dtype="float32")
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tmodels.init_cache(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tsteps.CompiledServeStep(cfg, params, cache, 2)
    srv = tserve.Server(cfg, max_batch=2, max_len=16, device="cpu")
    assert not isinstance(srv.step_fn, tsteps.CompiledServeStep)
    srv.params = params
    assert srv.params is params
    assert not isinstance(srv.step_fn, tsteps.CompiledServeStep)


def test_tensor_addresses_tell_captured_tensors_from_others():
    cfg = tconfigs.get_smoke_config("zamba2-2.7b")
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0))
    cache = tmodels.init_cache(cfg, 2, 16, device="cpu")
    seen = tsteps.tensor_addresses(params, cache)
    assert seen == tsteps.tensor_addresses(params, cache)
    assert seen != tsteps.tensor_addresses(params, _copy(cache))
    other = dict(params, embed=params["embed"].clone())
    assert seen != tsteps.tensor_addresses(other, cache)
    params["embed"].add_(1)                     # in place: same tensors
    assert seen == tsteps.tensor_addresses(params, cache)
