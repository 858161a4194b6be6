"""PICNIC sequence-sharded decode in the port (ROADMAP §A6a): the mesh,
the sharding context, the paged kernel's partial mode and
``models.attention.picnic_decode_attention``, held to the JAX package.

- The partial mode's plain version, cut into shards with ``key_offset``,
  against ``repro.models.attention.decode_attention_partial`` on every
  shard with a kept key, and the combined output against the reference's
  ``decode_attention``.
- The reference's own picnic decode on an ``Auto``-axes (2, 4) mesh of 8
  host devices (one subprocess), against the port's on an 8-rank gloo
  world (one subprocess a rank, rendezvous through a file store): yi-34b
  smoke, float32, a prompt of 20 into 32 cache rows, 8 greedy steps, so
  the owning shard moves from 2 to 3; with and without a window of 12,
  under which shard 0 holds no kept key and shard 1's last one drops out
  at the last step; and the sequence over both axes (8 shards, the
  hierarchical combine), where the owner moves from shard 5 to 6.
- ``gpu`` tests: the kernel's partial mode against its plain version on
  the card, and ``CompiledServeStep``'s refusal under a gloo picnic
  context.

The file imports JAX only inside the tests that need it, so the ``gpu``
tests run where JAX is not installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_picnic.py
"""
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (NEG_INF, identity_block_table,
                                                 paged_attention_plain, split_plan)
from repro_torch.launch import mesh as port_mesh

SRC = str(Path(__file__).resolve().parents[1] / "src")
# partials and logits: float32 sums in another order in the two packages
REL = 1e-5
# the world test: yi-34b smoke (2 layers, 4 heads on 2 KV heads of 32),
# float32, on a (2, 4) ("data", "model") mesh; each run: (batch, seq_axes,
# window).  B4 splits over "data" and the sequence over "model" (8 rows a
# shard); "long" is the reference's long-context layout: the sequence over
# both axes (4 rows a shard, the combine hierarchical: "data", then
# "model"), B3 replicated since 3 does not split over "data"
PROMPT, KV_MAX, NEW = 20, 32, 8
MESH = (2, 4)
RUNS = {"full": (4, ("model",), None), "window": (4, ("model",), 12),
        "long": (3, ("data", "model"), None)}
RUN_TIMEOUT = 240                    # seconds, each subprocess


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# The mesh and the context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_refuses_a_world_of_another_size(multi_pod):
    with pytest.raises(ValueError, match="256 ranks" if not multi_pod else "512 ranks"):
        port_mesh.make_production_mesh(multi_pod=multi_pod)


def test_importing_the_mesh_module_touches_no_process_group():
    code = ("import sys; sys.path.insert(0, %r); import torch.distributed as dist; "
            "import repro_torch.launch.mesh, repro_torch.sharding; "
            "assert not dist.is_initialized()" % SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=RUN_TIMEOUT)
    assert r.returncode == 0, r.stderr[-2000:]


def test_sharding_context_is_thread_local_and_nests():
    a = sharding.ShardingCtx("mesh-a", {"kv_cache": ("data",)}, {"picnic_decode": True})
    b = sharding.ShardingCtx("mesh-b", {})
    seen = {}
    assert sharding.current() is None
    with sharding.use_sharding(a):
        assert sharding.current() is a
        with sharding.use_sharding(b):
            assert sharding.current() is b
            t = threading.Thread(target=lambda: seen.setdefault("other", sharding.current()))
            t.start()
            t.join()
        assert sharding.current() is a
    assert sharding.current() is None and seen["other"] is None
    assert a.spec("kv_cache") == ("data",) and a.spec("logits") is None
    assert a.opt("picnic_decode") is True
    assert a.opt("seq_axes", ("model",)) == ("model",) and b.opt("dp_axes") is None


def test_shard_hint_returns_its_input():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.shard_hint(x, "act_btd") is x
    with sharding.use_sharding(sharding.ShardingCtx("mesh", {"act_btd": ("data",)})):
        assert sharding.shard_hint(x, "act_btd") is x


# ---------------------------------------------------------------------------
# The partial mode's plain version against the reference's partial
# ---------------------------------------------------------------------------

def _shard_inputs(seed, b, s, hq, hkv, d):
    g = np.random.default_rng(seed)
    q = g.standard_normal((b, hq, d)).astype(np.float32)
    k = g.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = g.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _port_shard(q, k, v, lens, n_shards, i, bt, window):
    """Shard i of n of the (B, S, Hkv, D) cache as a pool under its
    identity table: the partial mode's (o, m, l) as numpy."""
    b, s, hkv, d = k.shape
    sl = s // n_shards
    ks = torch.from_numpy(k[:, i * sl:(i + 1) * sl].copy())
    vs = torch.from_numpy(v[:, i * sl:(i + 1) * sl].copy())
    pool_k, pool_v = (t.view(b * sl // bt, bt, hkv, d) for t in (ks, vs))
    out = ops.paged_attention_partial(torch.from_numpy(q), pool_k, pool_v,
                                      identity_block_table(b, sl, bt),
                                      torch.tensor(lens, dtype=torch.int32),
                                      key_offset=i * sl, window=window)
    return [t.numpy() for t in out]


@pytest.mark.parametrize("window", [None, 12, 3])
@pytest.mark.parametrize("bt", [4, 8])
def test_partial_plain_matches_the_reference_on_every_shard(window, bt):
    import jax.numpy as jnp
    from repro.models.attention import decode_attention, decode_attention_partial

    b, s, hq, hkv, d, n = 4, 32, 4, 2, 32, 4
    sl = s // n
    lens = [5, 17, 32, 26]
    q, k, v = _shard_inputs(0, b, s, hq, hkv, d)
    parts, kept_shards = [], 0
    for i in range(n):
        o, m, l = _port_shard(q, k, v, lens, n, i, bt, window)
        parts.append((o, m, l))
        kpos = i * sl + np.arange(sl)
        ctx = np.asarray(lens)[:, None]
        valid = kpos[None, :] < ctx
        if window is not None:
            valid &= kpos[None, :] >= ctx - window
        ro, rm, rl = (np.asarray(t).reshape(b, hq, *t.shape[3:]) for t in
                      decode_attention_partial(jnp.asarray(q), jnp.asarray(k[:, i * sl:(i + 1) * sl]),
                                               jnp.asarray(v[:, i * sl:(i + 1) * sl]),
                                               jnp.asarray(valid)))
        kept = valid.any(axis=1)
        kept_shards += int(kept.any())
        if kept.any():
            for got, want in ((o, ro), (m, rm), (l, rl)):
                assert _rel(got[kept], want[kept]) <= REL, (i, _rel(got[kept], want[kept]))
        # a sequence with no kept key in the shard: (0, NEG_INF, 0)
        assert not o[~kept].any() and not l[~kept].any()
        assert (m[~kept] == NEG_INF).all()
    assert kept_shards >= 2
    o, m, l = (np.stack(t) for t in zip(*parts))          # (n, B, H, ...)
    M = m.max(axis=0)
    w = np.exp(m - M)
    combined = (o * w[..., None]).sum(0) / np.maximum((l * w).sum(0), 1e-30)[..., None]
    want = decode_attention(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens)[:, None], window=window)
    assert _rel(combined, np.asarray(want)[:, 0]) <= REL


def test_partial_plain_normalises_to_the_ordinary_call():
    q, k, v = _shard_inputs(1, 3, 24, 4, 2, 32)
    lens = torch.tensor([1, 13, 24], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k).view(18, 4, 2, 32),
            torch.from_numpy(v).view(18, 4, 2, 32), identity_block_table(3, 24, 4), lens)
    for window in (None, 5):
        o, m, l = ops.paged_attention_partial(*args, window=window)
        want = ops.paged_attention(*args, window=window)
        assert torch.allclose(o / l[..., None], want, rtol=0, atol=1e-6)


def test_partial_mode_refusals():
    q, k, v = _shard_inputs(2, 1, 8, 2, 2, 32)
    args = (torch.from_numpy(q), torch.from_numpy(k).view(2, 4, 2, 32),
            torch.from_numpy(v).view(2, 4, 2, 32), identity_block_table(1, 8, 4),
            torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError, match="no PWL"):
        paged_attention_plain(*args, use_pwl=True, partial=True)
    with pytest.raises(ValueError, match="key_offset"):
        ops.paged_attention_partial(*args, key_offset=-1)


# ---------------------------------------------------------------------------
# The reference's sharded run and the port's 8-rank world
# ---------------------------------------------------------------------------

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
from repro import models
from repro.configs import get_smoke_config
from repro.sharding import ShardingCtx, use_sharding
from repro.sharding import specs as sp

out = sys.argv[1]
PROMPT, KV_MAX, NEW, RUNS = {PROMPT}, {KV_MAX}, {NEW}, {RUNS!r}
assert len(jax.devices()) == 8
base = dataclasses.replace(get_smoke_config("yi-34b"), dtype="float32")
mesh = jax.make_mesh({MESH}, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
params = models.init_params(base, jax.random.PRNGKey(0))
flat = {{}}
def walk(tree, prefix):
    for key, val in tree.items():
        if isinstance(val, dict):
            walk(val, prefix + key + "/")
        else:
            flat[prefix + key] = np.asarray(val)
walk(params, "")
np.savez(out + "/params.npz", **flat)
toks = jax.random.randint(jax.random.PRNGKey(1), (4, PROMPT), 0, base.vocab_size)
np.save(out + "/tokens.npy", np.asarray(toks))
for name, (b, seq_axes, window) in RUNS.items():
    cfg = dataclasses.replace(base, sliding_window=window)
    logits, _, cache = models.forward(cfg, params, toks[:b], collect_cache=True,
                                      kv_max=KV_MAX)
    tok = jnp.argmax(logits[:, -1:], -1)
    rules = sp.activation_rules(cfg, mesh, "decode", long_context=len(seq_axes) > 1)
    ctx = ShardingCtx(mesh, rules, {{
        "picnic_decode": True, "seq_axes": seq_axes, "dp_axes": ("data",)}})
    def step(params, cache, tok, n, cfg=cfg, ctx=ctx):
        with use_sharding(ctx):
            return models.decode_step(cfg, params, tok, cache, n)
    step = jax.jit(step)
    ids, step_logits = [np.asarray(tok)], []
    for i in range(NEW):
        lg, cache = step(params, cache, tok, jnp.int32(PROMPT + i + 1))
        step_logits.append(np.asarray(lg[:, 0]))
        tok = jnp.argmax(lg[:, -1:], -1)
        ids.append(np.asarray(tok))
    caches = {{f"{{key}}/{{n}}": np.asarray(t) for key, e in cache.items() for n, t in e.items()}}
    np.savez(out + f"/ref_{{name}}.npz", ids=np.concatenate(ids, 1),
             logits=np.stack(step_logits), **caches)
print("reference ok")
"""

RANK = """
import datetime
import os
import sys
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{out}}/store", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import models, sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import CompiledServeStep
from repro_torch.params import from_jax

PROMPT, KV_MAX, NEW, RUNS = {PROMPT}, {KV_MAX}, {NEW}, {RUNS!r}
mesh = init_device_mesh("cpu", {MESH}, mesh_dim_names=("data", "model"))
host = make_host_mesh("cpu")
tree = {{}}
for key, val in np.load(out + "/params.npz").items():
    node = tree
    *path, leaf = key.split("/")
    for p in path:
        node = node.setdefault(p, {{}})
    node[leaf] = val
params = from_jax(tree, "cpu")
toks = torch.from_numpy(np.load(out + "/tokens.npy")).long()
n_dp = sharding.axes_size(mesh, ("data",))
base = dataclasses.replace(get_smoke_config("yi-34b"), dtype="float32")
saved = {{"host_mesh": np.array([*host.mesh.shape, host.mesh_dim_names == ("data", "model")])}}
for name, (b, seq_axes, window) in RUNS.items():
    cfg = dataclasses.replace(base, sliding_window=window)
    bl = b // n_dp if b % n_dp == 0 else b
    b0 = sharding.axes_index(mesh, ("data",)) * bl if b % n_dp == 0 else 0
    rows = slice(b0, b0 + bl)
    with torch.no_grad():
        logits, _, cache = models.forward(cfg, params, toks[:b], collect_cache=True,
                                          kv_max=KV_MAX)
        local = sharding.local_cache(cache, mesh, seq_axes=seq_axes)
        tok = torch.argmax(logits[rows, -1:], -1)
        ctx = sharding.ShardingCtx(mesh, {{}}, {{
            "picnic_decode": True, "seq_axes": seq_axes, "dp_axes": ("data",)}})
        ids, step_logits = [tok], []
        with sharding.use_sharding(ctx):
            for i in range(NEW):
                # an int length, and a 0-dim tensor (no host read) every other step
                n = PROMPT + i + 1
                lg, local = models.decode_step(cfg, params, tok, local,
                                               n if i % 2 else torch.tensor(n))
                step_logits.append(lg[:, 0])
                tok = torch.argmax(lg[:, -1:], -1)
                ids.append(tok)
            try:
                CompiledServeStep(cfg, params, local, bl)
                refusal = ""
            except ValueError as e:
                refusal = str(e)
    saved.update({{f"{{name}}/ids": torch.cat(ids, 1).numpy(),
                   f"{{name}}/seq_index": np.array(sharding.axes_index(mesh, seq_axes)),
                   f"{{name}}/logits": torch.stack(step_logits).numpy(),
                   f"{{name}}/refusal": np.array(refusal)}})
    saved.update({{f"{{name}}/cache/{{key}}/{{n}}": t.numpy() for key, e in local.items()
                   for n, t in e.items()}})
np.savez(out + f"/rank{{rank}}.npz", **saved)
dist.barrier()                  # no rank tears gloo down while another still talks
dist.destroy_process_group()
"""


def _fill(code):
    return textwrap.dedent(code).format(src=SRC, PROMPT=PROMPT, KV_MAX=KV_MAX, NEW=NEW,
                                        RUNS=RUNS, MESH=MESH)


def run_world(code: str, world: int, out: Path, timeout: float = RUN_TIMEOUT, env=None):
    """``code`` as ``world`` processes (argv: rank, world, out), each with
    its own timeout; every process is stopped before this returns."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env or {})}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(world)]
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
def picnic_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("picnic")
    r = subprocess.run([sys.executable, "-c", _fill(REFERENCE), str(out)],
                       capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert r.returncode == 0, f"reference:\n{r.stdout}\n{r.stderr[-3000:]}"
    run_world(_fill(RANK), MESH[0] * MESH[1], out)
    ref = {name: dict(np.load(out / f"ref_{name}.npz")) for name in RUNS}
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(MESH[0] * MESH[1])]
    return ref, ranks


def _rank_rows(r, name):
    """(batch rows, cache rows, seq index) of rank r on the (2, 4) mesh in
    run ``name``: the ranks are row-major over ("data", "model")."""
    b, seq_axes, _ = RUNS[name]
    n_dp, n_model = MESH
    i_dp, i_model = divmod(r, n_model)
    i_seq, n_seq = (i_model, n_model) if seq_axes == ("model",) else (r, n_dp * n_model)
    sl = KV_MAX // n_seq
    rows = slice(i_dp * b // n_dp, (i_dp + 1) * b // n_dp) if b % n_dp == 0 else slice(0, b)
    return rows, slice(i_seq * sl, (i_seq + 1) * sl), i_seq


@pytest.mark.parametrize("name", list(RUNS))
def test_picnic_greedy_ids_equal_the_reference_sharded_run(picnic_runs, name):
    ref, ranks = picnic_runs
    # the steps write rows 20..27: the owning shard changes on the way
    owners = {_rank_rows(r, name)[2] for r in range(len(ranks))
              if any(_rank_rows(r, name)[1].start <= PROMPT + i < _rank_rows(r, name)[1].stop
                     for i in range(NEW))}
    assert len(owners) == 2
    for r, got in enumerate(ranks):
        rows, _, i_seq = _rank_rows(r, name)
        assert int(got[f"{name}/seq_index"]) == i_seq
        np.testing.assert_array_equal(got[f"{name}/ids"], ref[name]["ids"][rows])


@pytest.mark.parametrize("name", list(RUNS))
def test_picnic_logits_match_the_reference_sharded_run(picnic_runs, name):
    ref, ranks = picnic_runs
    for r, got in enumerate(ranks):
        rows, _, _ = _rank_rows(r, name)
        want = ref[name]["logits"][:, rows]
        assert np.isfinite(got[f"{name}/logits"]).all()
        assert _rel(got[f"{name}/logits"], want) <= REL, (r, _rel(got[f"{name}/logits"], want))


@pytest.mark.parametrize("name", list(RUNS))
def test_picnic_cache_shards_equal_the_reference_cache_slices(picnic_runs, name):
    ref, ranks = picnic_runs
    keys = [k for k in ref[name] if k.endswith("/k") or k.endswith("/v")]
    assert keys
    for r, got in enumerate(ranks):
        rows, seq, _ = _rank_rows(r, name)
        for key in keys:
            mine, want = got[f"{name}/cache/{key}"], ref[name][key][:, rows, seq]
            assert mine.shape == want.shape
            # the same rows written (the rows past the last step are zero in both)
            written = np.abs(want).reshape(*want.shape[:3], -1).max(axis=(0, 1, 3)) > 0
            np.testing.assert_array_equal(
                np.abs(mine).reshape(*mine.shape[:3], -1).max(axis=(0, 1, 3)) > 0, written)
            assert _rel(mine, want) <= REL, (r, key, _rel(mine, want))


def test_picnic_world_meshes_and_the_compiled_step_refusal(picnic_runs):
    _, ranks = picnic_runs
    for got in ranks:
        assert got["host_mesh"].tolist() == [MESH[0] * MESH[1], 1, 1]
        for name in RUNS:
            assert "cannot be captured" in str(got[f"{name}/refusal"])
            assert "gloo" in str(got[f"{name}/refusal"])


# Every family under picnic decode, against the port's own single-process
# decode: two ranks, a (1, 2) mesh, smoke configs in float32, B2, 8 steps
# across the shard boundary.  Each entry: (config overrides, prompt
# tokens, cache rows).  zamba2's shared block keeps one cache per
# application and its mamba state is replicated; whisper's cross cache is
# not cut in the sequence; mixtral's window of 12 binds across the
# boundary; paligemma's 16-row image prefix lies in the first shard.
FAMILIES = {"zamba2-2.7b": ({}, 12, 32), "whisper-large-v3": ({}, 12, 32),
            "mixtral-8x7b": ({"sliding_window": 12}, 12, 32),
            "paligemma-3b": ({}, 4, 48), "mamba2-2.7b": ({}, 12, 32)}

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
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import models, sharding
from repro_torch.configs import get_smoke_config

NEW, B = {NEW}, 2
mesh = init_device_mesh("cpu", (1, world), mesh_dim_names=("data", "model"))
ctx = sharding.ShardingCtx(mesh, {{}}, {{"picnic_decode": True}})
saved = {{}}
for arch, (over, prompt_len, rows) in {FAMILIES!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **over)
    params = models.init_params(cfg, torch.Generator().manual_seed(0))
    g = np.random.default_rng(1)
    toks = torch.from_numpy(g.integers(0, cfg.vocab_size, (B, prompt_len)))
    extra = {{}}
    if cfg.is_encoder_decoder:
        extra["encoder_embeds"] = torch.from_numpy(
            g.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.n_prefix_tokens:
        extra["prefix_embeds"] = torch.from_numpy(
            g.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32))
    start = prompt_len + cfg.n_prefix_tokens
    with torch.no_grad():
        logits, _, cache = models.forward(cfg, params, toks, collect_cache=True,
                                          kv_max=rows, **extra)
        local = sharding.local_cache(cache, mesh)
        tok = torch.argmax(logits[:, -1:], -1)
        ids, got, want = [tok], [], []
        for i in range(NEW):
            with sharding.use_sharding(ctx):
                lg, local = models.decode_step(cfg, params, ids[-1], local, start + i + 1)
            got.append(lg[:, 0])
            ref, cache = models.decode_step(cfg, params, ids[-1], cache, start + i + 1)
            want.append(ref[:, 0])
            ids.append(torch.argmax(lg[:, -1:], -1))
    saved[arch + "/got"] = torch.stack(got).numpy()
    saved[arch + "/want"] = torch.stack(want).numpy()
    saved[arch + "/rows"] = np.array([e["k"].shape[2] for e in local.values() if "k" in e])
np.savez(out + f"/family{{rank}}.npz", **saved)
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def family_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("picnic_families")
    code = textwrap.dedent(FAMILY_RANK).format(src=SRC, NEW=NEW, FAMILIES=FAMILIES)
    run_world(code, 2, out)
    return [dict(np.load(out / f"family{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_picnic_decode_matches_the_port_unsharded_for_each_family(family_runs, arch):
    _, prompt_len, rows = FAMILIES[arch]
    for got in family_runs:
        # every self-attention cache holds half the rows (none for mamba2)
        assert set(got[arch + "/rows"].tolist()) <= {rows // 2}
        assert (len(got[arch + "/rows"]) == 0) == (arch == "mamba2-2.7b")
        assert _rel(got[arch + "/got"], got[arch + "/want"]) <= REL
        np.testing.assert_array_equal(got[arch + "/got"].argmax(-1),
                                      got[arch + "/want"].argmax(-1))
    np.testing.assert_array_equal(family_runs[0][arch + "/got"], family_runs[1][arch + "/got"])


def test_local_cache_refuses_a_batch_and_a_sequence_cut_over_one_axis():
    class Mesh:             # one rank of a (2, 4) ("data", "model") mesh
        mesh_dim_names = ("data", "model")

        def size(self, dim):
            return MESH[dim]

        def get_local_rank(self, axis):
            return 0
    cache = {"b0_dense": {"k": torch.zeros(1, 4, 32, 2, 8), "v": torch.zeros(1, 4, 32, 2, 8)}}
    with pytest.raises(ValueError, match="share an axis"):
        sharding.local_cache(cache, Mesh(), seq_axes=("data", "model"))
    # a batch that does not split over "data" is replicated, as in the reference
    odd = {"b0_dense": {"k": torch.ones(1, 3, 32, 2, 8)}}
    got = sharding.local_cache(odd, Mesh(), seq_axes=("data", "model"))["b0_dense"]["k"]
    assert got.shape == (1, 3, 4, 2, 8)
    assert got.data_ptr() != odd["b0_dense"]["k"].data_ptr()


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


def _card_shards(cuda, dtype, b, s, hq, hkv, d, n, bt, lens, window, seed=0):
    g = np.random.default_rng(seed)
    def randn(shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    q, k, v = randn((b, hq, d)), randn((b, s, hkv, d)), randn((b, s, hkv, d))
    sl = s // n
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    table = identity_block_table(b, sl, bt, device=cuda)
    for i in range(n):
        pk, pv = (t[:, i * sl:(i + 1) * sl].contiguous().view(b * sl // bt, bt, hkv, d)
                  for t in (k, v))
        yield i, (q, pk, pv, table, lens), dict(key_offset=i * sl, window=window)


def _hold_partial(got, want, case):
    o, m, l = got
    wo, wm, wl = want
    empty = wl == 0
    assert torch.equal(empty, l == 0), case
    assert (o[empty] == 0).all() and (m[empty] == NEG_INF).all(), case
    live = ~empty
    if live.any():
        for a, b_ in ((o, wo), (m, wm), (l, wl)):
            assert _rel(a[live].cpu(), b_[live].cpu()) <= REL, (case, _rel(a[live].cpu(),
                                                                           b_[live].cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("window", [None, 300, 100])
def test_partial_kernel_matches_plain_at_llama3_8b_decode(cuda, dtype, n_shards, window):
    """B4 H32 Hkv8 D128 over 1024 rows cut into shards: contexts that end
    in each shard, windows across a boundary, shards with no kept key."""
    lens = [1024, 700, 513, 300]
    for i, args, kw in _card_shards(cuda, dtype, 4, 1024, 32, 8, 128, n_shards, 64, lens,
                                    window):
        got = ops.paged_attention_partial(*args, **kw)
        want = paged_attention_plain(*args, partial=True, **kw)
        _hold_partial(got, want, (n_shards, i, window))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partial_kernel_head_dims_and_split_plans(cuda, d, dtype):
    """One sequence of one KV head (many splits) and a batch of 2 CTAs an
    SM (one split), at D 80 / 128 / 256, a window across the boundary of
    2 shards and an empty shard."""
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    bt = 64 if not (d == 256 and dtype == torch.float32) else 32
    for b, hkv in ((1, 1), (2 * n_sms, 1)):
        lens = [900 - 3 * j for j in range(b)]
        plan = split_plan(b * hkv, 512 // bt, bt, n_sms)[0]
        assert (plan > 1) == (b == 1)
        for window in (None, 200, 60):
            for i, args, kw in _card_shards(cuda, dtype, b, 1024, 4 * hkv, hkv, d, 2, bt,
                                            lens, window):
                got = ops.paged_attention_partial(*args, **kw)
                want = paged_attention_plain(*args, partial=True, **kw)
                _hold_partial(got, want, (b, window, i))


@pytest.mark.gpu
def test_partial_kernel_refusals_and_launch_key(cuda):
    args = (torch.zeros((1, 2, 32), device=cuda), torch.zeros((2, 4, 2, 32), device=cuda),
            torch.zeros((2, 4, 2, 32), device=cuda), identity_block_table(1, 8, 4, device=cuda),
            torch.tensor([8], dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="key_offset"):
        ops.paged_attention_partial(*args, key_offset=-1)
    with pytest.raises(NotImplementedError, match="ROADMAP §B2"):
        ops.paged_attention_partial(args[0].clone().requires_grad_(), *args[1:])
    ops.reset_launch_counts()
    ops.paged_attention_partial(*args, key_offset=8)
    ops.paged_attention(*args)
    keys = sorted(key for _, key in ops.LAUNCHES_BY_SHAPE)
    assert len(keys) == 2 and keys[1].endswith("mode=partial")
    assert ops.LAUNCHES["paged_attention"] == 2


CARD_RANK = """
import datetime
import sys
sys.path.insert(0, {src!r})
import torch
import torch.distributed as dist
rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{{out}}/store", rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import models, sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import CompiledServeStep
torch.cuda.set_device(rank % torch.cuda.device_count())
mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
cfg = get_smoke_config("llama3-8b")
params = models.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
cache = sharding.local_cache(models.init_cache(cfg, 2, 64, device="cuda"), mesh)
ctx = sharding.ShardingCtx(mesh, {{}}, {{"picnic_decode": True}})
with sharding.use_sharding(ctx):
    try:
        CompiledServeStep(cfg, params, cache, 2)
        raise SystemExit("CompiledServeStep captured a gloo picnic step")
    except ValueError as e:
        assert "cannot be captured" in str(e), e
dist.barrier()
dist.destroy_process_group()
"""


@pytest.mark.gpu
def test_compiled_serve_step_refuses_a_gloo_picnic_context(cuda, tmp_path):
    run_world(textwrap.dedent(CARD_RANK).format(src=SRC), 2, tmp_path)
