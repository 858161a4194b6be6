"""Sequence-parallel attention in the port (ROADMAP §A6c): ``q_offset`` in
the flash plain versions and kernels, ``sharding.seq_gather`` /
``seq_slice``, ``models.attention.sp_flash_attention``, the sequence cut
of ``models.forward``, the sharded train step and the prefill under
``sp_attention``, held to the JAX package.

- The plain forward and backward with ``q_offset`` against the
  reference's ``models.attention.flash_attention(q_offset=)`` and its
  ``jax.vjp`` (one process).
- One JAX subprocess with 8 host devices runs the reference on an
  ``Auto``-axes (2, 4) ("data", "model") mesh (ROADMAP hazard 1), its
  inputs made by numpy: ``sp_flash_attention`` with ``jax.vjp`` through its
  ``shard_map``; the sharded train step under ``sp_attention`` (3 steps of
  smollm-360m smoke at B4 x S2048 and mixtral-8x7b smoke at B4 x S1280,
  where the window of 64 and the MoE aux loss bind, float32; the
  reference's sp branch runs above S 1024); llama3.2-1b smoke's prefill
  of S 2048 under ``sp_attention``, then 4 greedy steps of PICNIC decode.
- One world of 8 torch ranks over gloo (a file store in tmp_path, one
  process a rank) runs the port's counterparts from the same numbers; the
  PICNIC decode goes on from the cache shard the sequence-parallel
  prefill returns, with no single-rank prefill.
- One world of 2 ranks on a (1, 2) mesh runs the ssm, hybrid, audio and
  vlm families' sharded train step and prefill under ``sp_attention``
  against the port's own single-process ones (held to JAX elsewhere).
- ``gpu`` tests: the flash kernels with ``q_offset`` (offsets 0, 1, 250,
  1024: off and on the 16- and 64-row tiles) against their plain versions,
  forward and backward, and ``seq_gather`` / ``seq_slice`` on CUDA tensors
  over gloo.

The file imports JAX only inside the tests that need it and in its
subprocess, so the ``gpu`` tests run where JAX is not installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_sp.py
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from test_torch_picnic import run_world

SRC = str(Path(__file__).resolve().parents[1] / "src")
RUN_TIMEOUT = 240                    # seconds, each subprocess
# float32 sums in another order: the plain version's 128-key steps against
# the reference's 512-key chunks; the sharded step's sums over ranks
REL = 1e-5
# each leaf's update after 3 steps, relative L2 (tests/test_torch_train.py's
# UPDATE_RTOL; ROADMAP hazard 10)
UPDATE_RTOL = 1e-3
MESH = (2, 4)
STEPS = 3
HYPER = dict(warmup=1, total_steps=10)
SP_OPTIONS = {"sp_attention": True, "seq_axes": ("model",), "dp_axes": ("data",)}
# (c): arch, B, S
TRAIN = {"dense": ("smollm-360m", 4, 2048), "moe": ("mixtral-8x7b", 4, 1280)}
# (e): llama3.2-1b smoke, a prompt of S into KV_MAX rows (576 a shard), NEW steps
PREFILL_S, KV_MAX, NEW = 2048, 2304, 4
# (d): arch, text rows S, prefix or encoder rows; B2 on a (1, 2) mesh
FAMILIES = {"ssm": ("mamba2-2.7b", 64), "hybrid": ("zamba2-2.7b", 64),
            "audio": ("whisper-large-v3", 32), "vlm": ("paligemma-3b", 16)}
VLM_PREFIX = 16                      # with S 16: rank 0 holds only prefix rows


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# (a) q_offset in the plain versions, one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q_offset", [0, 1, 37, 64])
@pytest.mark.parametrize("mode", ["causal", "window", "prefix"])
def test_plain_q_offset_matches_the_reference_and_its_vjp(q_offset, mode):
    """Query rows at q_offset .. q_offset + Sq - 1 against Skv = q_offset +
    Sq + 8 keys (Sq < Skv; every row sees a key): the output within 1e-5 of
    the reference's blockwise flash_attention(q_offset=), and dQ, dK, dV of
    flash_attention_bwd_plain within 1e-5 relative of jax.vjp of it."""
    import jax
    import jax.numpy as jnp
    from repro.models.attention import flash_attention as jax_flash

    kw = {"causal": {}, "window": {"window": 24}, "prefix": {"prefix_len": 16}}[mode]
    b, sq, hq, hkv, d = 2, 40, 4, 2, 32
    skv = q_offset + sq + 8
    g = np.random.default_rng(q_offset + len(mode))
    q, dout = (g.standard_normal((b, sq, hq, d)).astype(np.float32) for _ in range(2))
    k, v = (g.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))

    def ref(q, k, v):
        return jax_flash(q, k, v, causal=True, q_offset=q_offset, q_chunk=16, kv_chunk=32,
                         **kw)
    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, dout))
    out, lse = fa.flash_attention_plain(tq, tk, tv, q_offset=q_offset, return_lse=True, **kw)
    assert _rel(out.numpy(), np.asarray(want)) <= REL
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=REL)
    assert torch.equal(ops.flash_attention(tq, tk, tv, q_offset=q_offset, **kw), out)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, q_offset=q_offset, **kw)
    for name, a, w in zip("qkv", got, want_grads):
        assert _rel(a.numpy(), np.asarray(w)) <= REL, name
    # the offset is the rows' place: the same rows cut from a whole sequence
    full_q = torch.cat([torch.zeros(b, q_offset, hq, d), tq], dim=1)
    whole = fa.flash_attention_plain(full_q, tk, tv, **kw)[:, q_offset:]
    assert (whole - out).abs().max().item() <= 1e-6


def test_q_offset_is_refused_when_negative_and_named_in_the_launch_key():
    x = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(x, x, x, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_bwd_plain(x, x, x, x, torch.zeros(1, 2, 8), x, q_offset=-3)
    assert fa.launch_key(x, x) == fa.launch_key(x, x, q_offset=0)
    assert fa.launch_key(x, x, q_offset=250).endswith(" q_offset=250")


# ---------------------------------------------------------------------------
# (b), (c), (e): the reference on 8 host devices and the port on 8 ranks
# ---------------------------------------------------------------------------

INPUTS = """
def attention_inputs():
    g = np.random.default_rng(5)
    q = g.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k, v = (g.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(2))
    return q, k, v, g.standard_normal((2, 64, 4, 16)).astype(np.float32)

def batches(vocab, b, s):
    g = np.random.default_rng(s)
    out = []
    for _ in range({STEPS}):
        toks = g.integers(0, vocab, (b, s)).astype(np.int32)
        mask = np.ones((b, s), np.float32)
        mask[0, :9] = 0
        mask[1, s // 2 - 40:s // 2 + 40] = 0
        mask[3, g.integers(0, s, 60)] = 0
        out.append({{"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask}})
    return out

def prompt(vocab):
    return np.random.default_rng(11).integers(0, vocab, (4, {PREFILL_S})).astype(np.int32)
"""

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType
from repro import models, optim
from repro.configs import get_smoke_config
from repro.launch.steps import make_prefill_step, make_train_step
from repro.models import attention as attn
from repro.sharding import ShardingCtx, use_sharding
from repro.sharding import specs as sp
{inputs}
out = sys.argv[1]
assert len(jax.devices()) == 8
mesh = jax.make_mesh({MESH}, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
OPTIONS = {SP_OPTIONS!r}

def flat(tree):
    return {{"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

# (b) sp_flash_attention and jax.vjp through its shard_map
calls = []
real = attn.flash_attention
def counted(*a, **kw):
    calls.append(kw.get("q_offset"))
    return real(*a, **kw)
q, k, v, g = attention_inputs()
saved = {{}}
for window in (None, 24):
    def f(q, k, v, window=window):
        return attn.sp_flash_attention(q, k, v, mesh=mesh, dp_axes=("data",),
                                       seq_axes=("model",), causal=True, window=window,
                                       q_chunk=8, kv_chunk=16)
    o, vjp = jax.vjp(jax.jit(f), q, k, v)
    dq, dk, dv = vjp(jnp.asarray(g))
    tag = f"w{{window or 0}}"
    saved.update({{f"{{tag}}/out": np.asarray(o), f"{{tag}}/dq": np.asarray(dq),
                   f"{{tag}}/dk": np.asarray(dk), f"{{tag}}/dv": np.asarray(dv)}})
np.savez(out + "/ref_attention.npz", **saved)

# (c) the sharded train step under sp_attention
attn.flash_attention = counted
for name, (arch, b, s) in {TRAIN!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    state = optim.make_optimizer(cfg.optimizer)[0](params)
    bs = [{{k: jnp.asarray(v) for k, v in x.items()}} for x in batches(cfg.vocab_size, b, s)]
    ctx = ShardingCtx(mesh, sp.activation_rules(cfg, mesh, "train"), OPTIONS)
    pspecs = sp.param_specs(cfg, jax.eval_shape(lambda: params), mesh, "train")
    ospecs = sp.opt_state_specs(cfg, jax.eval_shape(lambda: state), pspecs, mesh)
    bspecs = sp.batch_specs(cfg, jax.eval_shape(lambda: bs[0]), mesh)
    step = make_train_step(cfg, **{HYPER!r})
    def wrapped(p, o, b, step=step, ctx=ctx):
        with use_sharding(ctx):
            return step(p, o, b)
    shardings = sp.to_named((pspecs, ospecs, bspecs), mesh)
    fn = jax.jit(wrapped, in_shardings=shardings)
    saved = {{"params0/" + k: v for k, v in flat(params).items()}}
    p, o = params, state
    del calls[:]
    for i, x in enumerate(bs):
        p, o, m = fn(*jax.device_put((p, o, x), shardings))
        saved.update({{f"metrics/{{i}}/{{k}}": np.asarray(v) for k, v in m.items()}})
    saved.update({{"params/" + k: v for k, v in flat(p).items()}})
    saved["sp_calls"] = np.array(len(calls))
    np.savez(out + f"/ref_{{name}}.npz", **saved)

# (e) prefill under sp_attention, then PICNIC decode
cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
params = models.init_params(cfg, jax.random.PRNGKey(0))
toks = jnp.asarray(prompt(cfg.vocab_size))
pctx = ShardingCtx(mesh, sp.activation_rules(cfg, mesh, "prefill"),
                   {{**OPTIONS, "sp_attention": True}})
dctx = ShardingCtx(mesh, sp.activation_rules(cfg, mesh, "decode"),
                   {{"picnic_decode": True, "seq_axes": ("model",), "dp_axes": ("data",)}})
prefill = make_prefill_step(cfg, kv_max={KV_MAX})
def pre(p, b):
    with use_sharding(pctx):
        return prefill(p, b)
def dec(p, c, t, n):
    with use_sharding(dctx):
        return models.decode_step(cfg, p, t, c, n)
del calls[:]
tok, cache = jax.jit(pre)(params, {{"tokens": toks}})
saved = {{"params0/" + k: v for k, v in flat(params).items()}}
saved["sp_calls"] = np.array(len(calls))
ids, logits = [np.asarray(tok)], []
step = jax.jit(dec)
for i in range({NEW}):
    lg, cache = step(params, cache, tok, jnp.int32({PREFILL_S} + i + 1))
    tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
    logits.append(np.asarray(lg[:, 0]))
    ids.append(np.asarray(tok))
saved["ids"] = np.concatenate(ids, 1)
saved["logits"] = np.stack(logits)
np.savez(out + "/ref_prefill.npz", **saved)
print("reference ok")
"""

RANK = """
import dataclasses
import datetime
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{out}}/store", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import models, sharding
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models.attention import sp_flash_attention
from repro_torch.optim import make_optimizer
from repro_torch.params import from_jax
from repro_torch.tree import tree_from_paths, tree_paths
{inputs}
mesh = init_device_mesh("cpu", {MESH}, mesh_dim_names=("data", "model"))
i_dp, i_seq = (sharding.axes_index(mesh, (a,)) for a in ("data", "model"))
saved = {{"coords": np.array([i_dp, i_seq])}}
ctx = sharding.ShardingCtx(mesh, {{}}, {SP_OPTIONS!r})

def flat(tree):
    return {{"/".join(path): t.detach().numpy() for path, t in tree_paths(tree)}}

def load(path):
    ref = np.load(path)
    return from_jax(tree_from_paths((tuple(k.split("/")[1:]), v) for k, v in ref.items()
                                    if k.startswith("params0/")), "cpu")

# (b) sp_flash_attention on this rank's batch row and 16 rows of the sequence
q, k, v, g = (torch.from_numpy(t) for t in attention_inputs())
rows = slice(16 * i_seq, 16 * (i_seq + 1))
for window in (None, 24):
    ql, kl, vl = (t[i_dp:i_dp + 1, rows].clone().requires_grad_(True) for t in (q, k, v))
    o, (kf, vf) = sp_flash_attention(ql, kl, vl, mesh=mesh, causal=True, window=window)
    dq, dk, dv = torch.autograd.grad(o, (ql, kl, vl), g[i_dp:i_dp + 1, rows])
    tag = f"w{{window or 0}}"
    saved.update({{f"{{tag}}/out": o.detach().numpy(), f"{{tag}}/dq": dq.numpy(),
                   f"{{tag}}/dk": dk.numpy(), f"{{tag}}/dv": dv.numpy(),
                   f"{{tag}}/k_full": kf.detach().numpy()}})

# (c) the sharded train step under sp_attention
def torch_batch(x):
    return {{"tokens": torch.from_numpy(x["tokens"]).long(),
             "labels": torch.from_numpy(x["labels"]).long(),
             "mask": torch.from_numpy(x["mask"])}}

for name, (arch, b, s) in {TRAIN!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = load(out + f"/ref_{{name}}.npz")
    state = make_optimizer(cfg.optimizer)[0](params)
    pspecs = sharding.param_specs(cfg, params, mesh, "train")
    ospecs = sharding.opt_state_specs(cfg, state, pspecs, mesh)
    ps, os_ = steps.shard_train_state(params, state, pspecs, ospecs, mesh)
    step = steps.make_sharded_train_step(cfg, ctx, pspecs, ospecs, **{HYPER!r})
    ops.reset_launch_counts()
    for i, x in enumerate(batches(cfg.vocab_size, b, s)):
        x = torch_batch(x)
        bspecs = sharding.batch_specs(cfg, x, mesh)
        ps, os_, m = step(ps, os_, {{k: sharding.local_shard(v, bspecs[k], mesh)
                                     for k, v in x.items()}})
        saved.update({{f"{{name}}/metrics/{{i}}/{{k}}": v.numpy() for k, v in m.items()}})
    with sharding.use_sharding(ctx):
        r = models.local_text_rows(s)
    saved[f"{{name}}/text_rows"] = np.array([r.start, r.stop])
    fp, _ = steps.gather_train_state(ps, os_, pspecs, ospecs, mesh)
    saved.update({{f"{{name}}/params/{{k}}": v for k, v in flat(fp).items()}})

# (e) the sequence-parallel prefill feeds PICNIC decode
cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), dtype="float32")
params = load(out + "/ref_prefill.npz")
toks = torch.from_numpy(prompt(cfg.vocab_size)).long()[2 * i_dp:2 * (i_dp + 1)]
ctx_serve = sharding.ShardingCtx(mesh, {{}}, {{**{SP_OPTIONS!r}, "picnic_decode": True}})
prefill = steps.make_prefill_step(cfg, kv_max={KV_MAX})
with sharding.use_sharding(ctx_serve):
    tok, cache = prefill(params, {{"tokens": toks}})
    saved["shard_rows"] = np.array(cache["b0_dense"]["k"].shape[2])
    ids, logits = [tok], []
    with torch.no_grad():
        for i in range({NEW}):
            lg, cache = models.decode_step(cfg, params, tok, cache, {PREFILL_S} + i + 1)
            tok = torch.argmax(lg[:, -1:], dim=-1)
            logits.append(lg[:, 0])
            ids.append(tok)
saved["prefill/ids"] = torch.cat(ids, 1).numpy()
saved["prefill/logits"] = torch.stack(logits).numpy()
np.savez(out + f"/rank{{rank}}.npz", **saved)
dist.barrier()                  # no rank tears gloo down while another still talks
dist.destroy_process_group()
"""

# (d) two ranks on a (1, 2) mesh against the port's single-process steps
FAMILY_RANK = """
import dataclasses
import datetime
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{out}}/store", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import models, sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.tree import tree_paths

mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
ctx = sharding.ShardingCtx(mesh, {{}}, {SP_OPTIONS!r})
saved = {{}}

def flat(tree):
    return {{"/".join(path): t.detach().numpy() for path, t in tree_paths(tree)}}

def batch_of(cfg, s, extra, seed):
    g = np.random.default_rng(seed)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (2, s))).long()
    mask = torch.ones(2, s)
    mask[1, s // 2 - 3:s // 2 + 5] = 0
    x = {{"tokens": toks, "labels": toks.roll(-1, 1), "mask": mask}}
    if cfg.family == "vlm":
        x["prefix_embeds"] = torch.from_numpy(
            g.standard_normal((2, extra, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        x["encoder_embeds"] = torch.from_numpy(
            g.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return x

for name, (arch, s) in {FAMILIES!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    xs = [batch_of(cfg, s, {VLM_PREFIX}, i) for i in range({STEPS})]
    init = lambda: steps.init_train_state(cfg, torch.Generator().manual_seed(0))
    params, state = init()
    single = steps.make_train_step(cfg, **{HYPER!r})
    for i, x in enumerate(xs):
        params, state, m = single(params, state, x)
        saved.update({{f"{{name}}/single/{{i}}/{{k}}": v.numpy() for k, v in m.items()}})
    saved.update({{f"{{name}}/single_params/{{k}}": v for k, v in flat(params).items()}})
    p0, state = init()
    saved.update({{f"{{name}}/params0/{{k}}": v for k, v in flat(p0).items()}})
    pspecs = sharding.param_specs(cfg, p0, mesh, "train")
    ospecs = sharding.opt_state_specs(cfg, state, pspecs, mesh)
    ps, os_ = steps.shard_train_state(p0, state, pspecs, ospecs, mesh)
    step = steps.make_sharded_train_step(cfg, ctx, pspecs, ospecs, **{HYPER!r})
    for i, x in enumerate(xs):
        ps, os_, m = step(ps, os_, x)
        saved.update({{f"{{name}}/metrics/{{i}}/{{k}}": v.numpy() for k, v in m.items()}})
    fp, _ = steps.gather_train_state(ps, os_, pspecs, ospecs, mesh)
    saved.update({{f"{{name}}/params/{{k}}": v for k, v in flat(fp).items()}})
    with sharding.use_sharding(ctx):
        try:
            steps.CompiledTrainStep(cfg, ps, os_)
            saved[f"{{name}}/refusal"] = np.array("")
        except ValueError as e:
            saved[f"{{name}}/refusal"] = np.array(str(e))
    # the prefill under sp_attention against the single-process one
    x = {{k: v for k, v in xs[0].items() if k not in ("labels", "mask")}}
    rows = s + (x["prefix_embeds"].shape[1] if "prefix_embeds" in x else 0)
    prefill = steps.make_prefill_step(cfg, kv_max=rows)
    with torch.no_grad():
        tok1, cache1 = prefill(p0, x)
        with sharding.use_sharding(ctx):
            tok, cache = prefill(p0, x)
            r = models.local_text_rows(s, x["prefix_embeds"].shape[1] if "prefix_embeds" in x
                                       else 0)
            logits = models.forward(cfg, p0, x["tokens"], prefix_embeds=x.get("prefix_embeds"),
                                    encoder_embeds=x.get("encoder_embeds"))[0]
        logits1 = models.forward(cfg, p0, x["tokens"], prefix_embeds=x.get("prefix_embeds"),
                                 encoder_embeds=x.get("encoder_embeds"))[0]
    saved[f"{{name}}/tok"] = (tok == tok1).all().numpy()
    saved[f"{{name}}/cache_rel"] = np.array(max(
        float((cache[k][n] - cache1[k][n]).norm() / cache1[k][n].norm().clamp_min(1e-30))
        for k in cache for n in cache[k]))
    saved[f"{{name}}/logit_rows"] = np.array(logits.shape[1])
    saved[f"{{name}}/logits_rel"] = np.array(
        float((logits - logits1[:, r]).norm() / logits1[:, r].norm().clamp_min(1e-30))
        if logits.shape[1] else 0.0)
    if name == "hybrid":
        # under remat, a backward outside the forward's context (autograd's
        # own thread runs it for CUDA tensors) recomputes with the cut
        rcfg = dataclasses.replace(cfg, remat=True)
        leaves = [t for _, t in tree_paths(p0)]
        loss = lambda: models.forward(rcfg, p0, xs[0]["tokens"])[0].float().square().mean()
        with sharding.use_sharding(ctx):
            inside = torch.autograd.grad(loss(), leaves, allow_unused=True)
            outside_loss = loss()
        outside = torch.autograd.grad(outside_loss, leaves, allow_unused=True)
        saved["hybrid/remat_equal"] = np.array(all(
            (a is None and b is None) or torch.equal(a, b) for a, b in zip(inside, outside)))
np.savez(out + f"/family{{rank}}.npz", **saved)
dist.barrier()
dist.destroy_process_group()
"""


def _fill(code):
    inputs = textwrap.dedent(INPUTS).format(STEPS=STEPS, PREFILL_S=PREFILL_S)
    return textwrap.dedent(code).format(
        src=SRC, inputs=inputs, MESH=MESH, TRAIN=TRAIN, HYPER=HYPER, SP_OPTIONS=SP_OPTIONS,
        KV_MAX=KV_MAX, PREFILL_S=PREFILL_S, NEW=NEW, FAMILIES=FAMILIES, VLM_PREFIX=VLM_PREFIX,
        STEPS=STEPS)


def _start_world(code, world, out):
    """``code`` as ``world`` processes (argv: rank, world, out), started."""
    import os
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env) for r in range(world)]


def _finish_world(procs, timeout=RUN_TIMEOUT):
    """Waits for every process of ``_start_world``; each is stopped before
    this returns."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, then the 8-rank world; the 2-rank world of
    (d) runs beside the reference (it needs none of its numbers)."""
    out = tmp_path_factory.mktemp("sp")
    fam = out / "families"
    fam.mkdir()
    families = _start_world(_fill(FAMILY_RANK), 2, fam)
    try:
        r = subprocess.run([sys.executable, "-c", _fill(REFERENCE), str(out)],
                           capture_output=True, text=True, timeout=RUN_TIMEOUT)
        assert r.returncode == 0, f"reference:\n{r.stdout}\n{r.stderr[-3000:]}"
        run_world(_fill(RANK), MESH[0] * MESH[1], out)
    finally:
        _finish_world(families)
    ref = {name: dict(np.load(out / f"ref_{name}.npz"))
           for name in ("attention", "prefill", *TRAIN)}
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(MESH[0] * MESH[1])]
    fams = [dict(np.load(fam / f"family{r}.npz")) for r in range(2)]
    return ref, ranks, fams


@pytest.mark.parametrize("window", [None, 24])
def test_sp_flash_attention_matches_the_reference_and_its_vjp(runs, window):
    """Each rank's rows of the output and of dQ, dK, dV (the reduce-scatter
    of the gathered K/V's gradients) at the reference's own shapes."""
    ref, ranks, _ = runs
    tag = f"w{window or 0}"
    want = ref["attention"]
    for got in ranks:
        i_dp, i_seq = (int(c) for c in got["coords"])
        rows = slice(16 * i_seq, 16 * (i_seq + 1))
        for name in ("out", "dq", "dk", "dv"):
            w = want[f"{tag}/{name}"][i_dp:i_dp + 1, rows]
            assert _rel(got[f"{tag}/{name}"], w) <= REL, (i_dp, i_seq, name)
            np.testing.assert_allclose(got[f"{tag}/{name}"], w, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[f"{tag}/k_full"].shape, (1, 64, 2, 16))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sp_train_step_matches_the_reference_sharded_run(runs, name):
    """3 steps under sp_attention on the (2, 4) mesh: the reference's sp
    branch ran, every rank's metrics within 1e-5 of the reference's, each
    leaf's update within 1e-3, ranks bit-equal; ranks along model hold
    other text rows of the sequence."""
    ref, ranks, _ = runs
    want = ref[name]
    _, b, s = TRAIN[name]
    assert int(want["sp_calls"]) > 0
    params0 = {k[len("params0/"):]: v for k, v in want.items() if k.startswith("params0/")}
    for r, got in enumerate(ranks):
        for i in range(STEPS):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[f"{name}/metrics/{i}/{k}"],
                                           want[f"metrics/{i}/{k}"], rtol=REL, atol=1e-12,
                                           err_msg=f"rank {r} step {i} {k}")
        for path, p0 in params0.items():
            mine, theirs = got[f"{name}/params/{path}"], want[f"params/{path}"]
            assert _rel(mine - p0, theirs - p0) <= UPDATE_RTOL, (r, path)
            np.testing.assert_array_equal(mine, ranks[0][f"{name}/params/{path}"])
        i_seq = int(got["coords"][1])
        assert list(got[f"{name}/text_rows"]) == [i_seq * s // 4, (i_seq + 1) * s // 4]
    if name == "moe":
        assert float(want["metrics/0/aux"]) > 1.0


def test_sp_prefill_feeds_picnic_decode_as_the_reference(runs):
    """llama3.2-1b smoke: the prefill of 2048 tokens under sp_attention on
    every rank, its cache shard (576 of 2304 rows) into 4 PICNIC decode
    steps: greedy ids equal to the reference's, logits within 1e-5."""
    ref, ranks, _ = runs
    want = ref["prefill"]
    assert int(want["sp_calls"]) > 0
    for r, got in enumerate(ranks):
        i_dp = int(got["coords"][0])
        assert int(got["shard_rows"]) == KV_MAX // MESH[1]
        np.testing.assert_array_equal(got["prefill/ids"], want["ids"][2 * i_dp:2 * i_dp + 2])
        w = want["logits"][:, 2 * i_dp:2 * i_dp + 2]
        assert _rel(got["prefill/logits"], w) <= REL, r
        np.testing.assert_allclose(got["prefill/logits"], w, rtol=0,
                                   atol=REL * float(np.abs(w).max()))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sp_families_match_the_single_process_step_and_prefill(runs, name):
    """The ssm, hybrid (mamba mixers on the gathered rows), audio (the
    encoder whole, the decoder cut) and vlm (a prefix the size of rank 0's
    rows: it returns no logit rows) families: 3 sharded steps under
    sp_attention on (1, 2) within 1e-5 / 1e-3 of the single-process steps;
    the prefill's next token equal and its cache, gathered whole on both
    ranks, within 1e-5; each rank's logits those of its text rows; under
    remat, the gradients of a backward run outside the forward's context
    (as autograd's CUDA thread runs it) equal to those inside it;
    ``CompiledTrainStep`` refuses the gloo sequence-parallel context."""
    _, _, fams = runs
    for r, got in enumerate(fams):
        for i in range(STEPS):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[f"{name}/metrics/{i}/{k}"],
                                           got[f"{name}/single/{i}/{k}"], rtol=REL, atol=1e-12,
                                           err_msg=f"rank {r} step {i} {k}")
        prefix = f"{name}/params0/"
        for path in (k[len(prefix):] for k in got if k.startswith(prefix)):
            p0 = got[prefix + path]
            mine, single = got[f"{name}/params/{path}"], got[f"{name}/single_params/{path}"]
            assert _rel(mine - p0, single - p0) <= UPDATE_RTOL, (r, path)
        assert bool(got[f"{name}/tok"])
        assert "cannot be captured" in str(got[f"{name}/refusal"])
        if name == "hybrid":
            assert bool(got["hybrid/remat_equal"])
        assert float(got[f"{name}/cache_rel"]) <= REL
        assert float(got[f"{name}/logits_rel"]) <= REL
    arch, s = FAMILIES[name]
    rows = [int(got[f"{name}/logit_rows"]) for got in fams]
    want = [0, s] if name == "vlm" else [s // 2, s // 2]
    assert rows == want, rows


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the Hopper kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, seed, device):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device, dtype)


OFFSETS = [0, 1, 250, 1024]
MODES = {"causal": {}, "window": {"window": 100}, "prefix": {"prefix_len": 300},
         "noncausal": {"causal": False}}


def _offset_case(dtype, q_offset, d, device, sq=200, extra=56):
    """Queries at q_offset .. q_offset + sq - 1 against q_offset + sq +
    extra keys (Sq < Skv), GQA 8 on 2."""
    skv = q_offset + sq + extra
    q = _randn((2, sq, 8, d), dtype, q_offset + d, device)
    k, v = (_randn((2, skv, 2, d), dtype, q_offset + d + i, device) for i in (1, 2))
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset", OFFSETS)
@pytest.mark.parametrize("mode", list(MODES))
def test_flash_kernel_q_offset_matches_plain(cuda, mode, q_offset, dtype):
    """The forward with and without its lse output against the plain
    version by flash_attention.agreement, the lse within 1e-5, counted
    under a launch key that names the offset."""
    kw = MODES[mode]
    q, k, v = _offset_case(dtype, q_offset, 64, cuda)
    before = dict(ops.LAUNCHES_BY_SHAPE)
    got = ops.flash_attention(q, k, v, q_offset=q_offset, **kw)
    got_lse, lse = fa._flash_fwd(q, k, v, causal=kw.get("causal", True), use_pwl=False,
                                 window=kw.get("window", 0), prefix_len=kw.get("prefix_len", 0),
                                 with_lse=True, q_offset=q_offset)
    want, want_lse = fa.flash_attention_plain(q, k, v, q_offset=q_offset, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, got_lse)
    err, ratio, rows_off, ok = fa.agreement(got, want)
    assert ok, (err, ratio, rows_off)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    key = ("flash_attention", fa.launch_key(q, k, q_offset=q_offset, causal=kw.get("causal", True),
                                            window=kw.get("window"),
                                            prefix_len=kw.get("prefix_len", 0)))
    assert ops.LAUNCHES_BY_SHAPE[key] == before.get(key, 0) + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_offset", OFFSETS)
@pytest.mark.parametrize("mode", list(MODES))
def test_flash_bwd_kernel_q_offset_matches_plain(cuda, mode, q_offset, dtype):
    """dQ, dK, dV of the backward kernel with q_offset by bwd_agreement
    against the plain backward (an offset that is no multiple of 64 runs
    the bf16 kernels compiled for a window, with a window wider than any
    sequence); through
    FlashAttentionFn under grad, one forward and one backward launch."""
    kw = MODES[mode]
    q, k, v = _offset_case(dtype, q_offset, 64, cuda)
    g = _randn(q.shape, dtype, 99, cuda)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention(q, k, v, q_offset=q_offset, **kw)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    _, lse = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(), q_offset=q_offset,
                                      return_lse=True, **kw)
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(), lse,
                                        g, q_offset=q_offset, **kw)
    for name, a, w in zip("qkv", got, want):
        err, ratio, ok = fa.bwd_agreement(a, w)
        assert ok, (name, err, ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 80, 128, 256])
def test_flash_kernels_q_offset_at_every_head_dim(cuda, d, dtype):
    """Offset 250 (no multiple of 16) at every other head dim, causal:
    forward and backward against the plain versions."""
    q, k, v = _offset_case(dtype, 250, d, cuda, sq=130, extra=3)
    g = _randn(q.shape, dtype, 7, cuda)
    out, lse = fa._flash_fwd(q, k, v, causal=True, use_pwl=False, window=0, prefix_len=0,
                             with_lse=True, q_offset=250)
    want = fa.flash_attention_plain(q, k, v, q_offset=250)
    assert fa.agreement(out, want)[3]
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, q_offset=250)
    plain = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, q_offset=250)
    for name, a, w in zip("qkv", got, plain):
        assert fa.bwd_agreement(a, w)[2], name


@pytest.mark.gpu
def test_flash_entries_refuse_a_negative_q_offset(cuda):
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.pwl import PWL_COEFFS
    q, k, v = _offset_case(torch.bfloat16, 0, 64, cuda, sq=64, extra=0)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    lib = _build.library("flash_attention")
    assert lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                                   2, 64, 64, 8, 2, 64, 1, 1, 0, 0, -1, 0,
                                   ctypes.addressof(PWL_COEFFS), stream) != 0
    lse = torch.zeros((2, 8, 64), device=cuda)
    grads = [torch.empty_like(t) for t in (q, k, v)] + [torch.empty_like(lse)]
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse, out)] + [t.data_ptr() for t in grads]
    bwd = _build.library("flash_attention_bwd")
    assert bwd.flash_attention_bwd(*ptrs, 2, 64, 64, 8, 2, 64, 1, 1, 0, 0, -1, 0, stream) != 0
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)


GPU_RANK = """
import datetime
import sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{out}}/store", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
torch.cuda.set_device(rank % torch.cuda.device_count())
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import sharding

mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
full = torch.randn(2, 8, 3, generator=torch.Generator().manual_seed(4)).cuda()
saved = {{}}
for dtype in (torch.float32, torch.bfloat16):
    mine = sharding.seq_slice(full.to(dtype), mesh, ("model",)).clone().requires_grad_(True)
    whole = sharding.seq_gather(mine, mesh, ("model",))
    w = torch.arange(whole.numel(), device="cuda", dtype=torch.float32).reshape(whole.shape)
    (whole.float() * w * (rank + 1)).sum().backward()
    # the SUM over both ranks of each one's gradient of this rank's rows
    want = sharding.seq_slice(w * sum(r + 1 for r in range(world)), mesh, ("model",))
    saved[str(dtype)] = (bool(whole.is_cuda and mine.grad.is_cuda),
                         bool(torch.equal(whole, full.to(dtype))),
                         bool(torch.equal(mine.grad.float(), want)))
torch.save(saved, f"{{out}}/gpu{{rank}}.pt")
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_seq_gather_and_slice_round_trip_on_cuda_over_gloo(cuda, tmp_path):
    run_world(textwrap.dedent(GPU_RANK).format(src=SRC), 2, tmp_path)
    for r in range(2):
        got = torch.load(tmp_path / f"gpu{r}.pt")
        assert got == {str(t): (True, True, True) for t in (torch.float32, torch.bfloat16)}
