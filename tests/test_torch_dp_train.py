"""The data-parallel layer of the port (ROADMAP §A6b) against the JAX
package's own sharded runs: the int8 compressed all-reduce
(``repro_torch.runtime.compression``), the sharded train step
(``launch.steps.make_sharded_train_step`` over ``sharding.specs``) and the
train driver started as two ranks.

- One JAX subprocess with 8 host devices runs the reference on ``Auto``
  axes (ROADMAP hazard 1): ``compressed_allreduce`` on an (8,) ("data",)
  mesh with ``g`` made by numpy, and ``make_train_step`` jitted with
  ``in_shardings=to_named((param_specs, opt_state_specs, batch_specs))``
  under ``activation_rules(..., "train")`` (no ``sp_attention``) on a
  (2, 4) ("data", "model") mesh: 3 steps of B4 x S64 with a mask that
  differs between the two data shards, for smollm-360m smoke (dense),
  mixtral-8x7b smoke (the MoE aux loss) and smollm with Adafactor, all
  float32.
- One world of 8 torch ranks over gloo (a file store in tmp_path, one
  thread a rank) runs the port's counterparts from the same numbers, and
  the sharded step with the RRAM weight noise against the port's own
  single-process step, and ``CompiledTrainStep``'s refusal under the gloo
  context.
- ``torchrun`` with 2 ranks runs ``repro_torch.launch.train`` with an
  injected failure, then resumes it from its checkpoint.
- ``gpu`` tests (two ranks on the card over gloo): ``compressed_psum`` on
  CUDA tensors bit-equal to the same call on CPU tensors, ``local_shard``
  / ``gather_shard`` round trips, ``CompiledTrainStep``'s refusal.

The file imports JAX only in its subprocess, so the ``gpu`` tests run where
JAX is not installed:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_dp_train.py
"""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.sharding import layout, specs as tspecs
from repro_torch.tree import tree_paths
from test_torch_picnic import run_world

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RUN_TIMEOUT = 240                    # seconds, each subprocess
# the metrics of a step: float32 sums in another order (the data-parallel
# sum of two shards' gradients, XLA's fused reductions), ~1e-7 apart
METRIC_RTOL = 1e-5
# each leaf's update after 3 steps against the reference's, relative L2
# (tests/test_torch_train.py's UPDATE_RTOL; ROADMAP hazard 10: AdamW and
# Adafactor divide the rounding of near-zero gradients by their own size)
UPDATE_RTOL = 1e-3
# the compressed all-reduce's error state: the port subtracts q * s_max as
# two IEEE operations, XLA contracts them into one FMA (ROADMAP hazard 8)
ERROR_ATOL = 1e-9
MESH = (2, 4)
B, S, STEPS = 4, 64, 3
CASES = {"dense": ("smollm-360m", "adamw"), "moe": ("mixtral-8x7b", "adamw"),
         "adafactor": ("smollm-360m", "adafactor")}
HYPER = dict(warmup=1, total_steps=10)

# the batches, made by numpy in both packages: per case 3 batches whose
# masks drop other tokens in the two data shards (rows 0-1 and 2-3).  The
# all-reduce's g is the reference test's (tests/test_distributed.py:
# normal(PRNGKey(0), (8, 128)) * 1e-3), handed to the port as numpy
INPUTS = """
def batches(vocab):
    g = np.random.default_rng(1)
    out = []
    for _ in range({STEPS}):
        toks = g.integers(0, vocab, ({B}, {S})).astype(np.int32)
        mask = np.ones(({B}, {S}), np.float32)
        mask[0, :9] = 0
        mask[1, 40:] = 0
        mask[3, g.integers(0, {S}, 20)] = 0
        out.append({{"tokens": toks, "labels": np.roll(toks, -1, 1), "mask": mask}})
    return out
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
from repro.launch.steps import make_train_step
from repro.runtime import compressed_allreduce
from repro.sharding import ShardingCtx, use_sharding
from repro.sharding import specs as sp
{inputs}
out = sys.argv[1]
assert len(jax.devices()) == 8
auto = lambda n: (AxisType.Auto,) * n

def flat(tree):
    return {{"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

mesh8 = jax.make_mesh((8,), ("data",), axis_types=auto(1))
g = jax.random.normal(jax.random.PRNGKey(0), (8, 128)) * 1e-3
red, err = jax.jit(lambda g, e: compressed_allreduce({{"g": g}}, {{"g": e}}, mesh8, "data"))(
    g, jnp.zeros_like(g))
exact = jnp.sum(g, axis=0, keepdims=True)
rel = float(jnp.linalg.norm(red["g"][:1] - exact) / jnp.linalg.norm(exact))
np.savez(out + "/compress.npz", g=np.asarray(g), out=np.asarray(red["g"]),
         err=np.asarray(err["g"]), rel=rel)

mesh = jax.make_mesh({MESH}, ("data", "model"), axis_types=auto(2))
for name, (arch, opt) in {CASES!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", optimizer=opt)
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    state = optim.make_optimizer(opt)[0](params)
    bs = [{{k: jnp.asarray(v) for k, v in b.items()}} for b in batches(cfg.vocab_size)]
    ctx = ShardingCtx(mesh, sp.activation_rules(cfg, mesh, "train"))
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
    for i, b in enumerate(bs):
        p, o, m = fn(*jax.device_put((p, o, b), shardings))
        saved.update({{f"metrics/{{i}}/{{k}}": np.asarray(v) for k, v in m.items()}})
    saved.update({{"params/" + k: v for k, v in flat(p).items()}})
    np.savez(out + f"/ref_{{name}}.npz", **saved)
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
                        world_size=world, timeout=datetime.timedelta(seconds=60))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch import sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.optim import make_optimizer
from repro_torch.params import from_jax
from repro_torch.runtime import compressed_allreduce
from repro_torch.tree import tree_from_paths, tree_paths
{inputs}
saved = {{}}
mesh8 = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
g = torch.from_numpy(np.load(out + "/compress.npz")["g"])
red, err = compressed_allreduce({{"g": g[rank:rank + 1]}}, {{"g": torch.zeros(1, 128)}},
                                mesh8, "data")
saved.update({{"compress/out": red["g"].numpy(), "compress/err": err["g"].numpy()}})

def torch_batch(b):
    return {{"tokens": torch.from_numpy(b["tokens"]).long(),
             "labels": torch.from_numpy(b["labels"]).long(),
             "mask": torch.from_numpy(b["mask"])}}

def flat(tree):
    return {{"/".join(path): t.detach().numpy() for path, t in tree_paths(tree)}}

mesh = init_device_mesh("cpu", {MESH}, mesh_dim_names=("data", "model"))
coords = [sharding.axes_index(mesh, (a,)) for a in ("data", "model")]
saved["coords"] = np.array(coords)
runs = {{name: (arch, opt, 0.0) for name, (arch, opt) in {CASES!r}.items()}}
runs["noise"] = ("smollm-360m", "adamw", 0.05)
for name, (arch, opt, noise) in runs.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", optimizer=opt)
    ref = np.load(out + f"/ref_{{name if name != 'noise' else 'dense'}}.npz")
    params = from_jax(tree_from_paths((tuple(k.split("/")[1:]), v) for k, v in ref.items()
                                      if k.startswith("params0/")), "cpu")
    state = make_optimizer(opt)[0](params)
    pspecs = sharding.param_specs(cfg, params, mesh, "train")
    ospecs = sharding.opt_state_specs(cfg, state, pspecs, mesh)
    ctx = sharding.ShardingCtx(mesh, sharding.activation_rules(cfg, mesh, "train"))
    ps, os_ = steps.shard_train_state(params, state, pspecs, ospecs, mesh)
    step = steps.make_sharded_train_step(cfg, ctx, pspecs, ospecs, weight_noise_std=noise,
                                         **{HYPER!r})
    single = steps.make_train_step(cfg, weight_noise_std=noise, **{HYPER!r})
    for i, b in enumerate(batches(cfg.vocab_size)):
        b = torch_batch(b)
        bspecs = sharding.batch_specs(cfg, b, mesh)
        ps, os_, m = step(ps, os_, {{k: sharding.local_shard(v, bspecs[k], mesh)
                                     for k, v in b.items()}})
        saved.update({{f"{{name}}/metrics/{{i}}/{{k}}": v.numpy() for k, v in m.items()}})
        if name == "noise":                 # the port's own single-process step
            params, state, m1 = single(params, state, b)
            saved.update({{f"{{name}}/single/{{i}}/{{k}}": v.numpy() for k, v in m1.items()}})
    fp, fo = steps.gather_train_state(ps, os_, pspecs, ospecs, mesh)
    saved.update({{f"{{name}}/shard/{{k}}": v for k, v in flat(ps).items()}})
    saved.update({{f"{{name}}/params/{{k}}": v for k, v in flat(fp).items()}})
    if name == "noise":
        saved.update({{f"{{name}}/single_params/{{k}}": v for k, v in flat(params).items()}})
    if name == "dense":
        # DTensor's cut by to_placements is local_shard's, on a two-axis entry
        spec_of = dict(tree_paths(ospecs))
        path, leaf = next((p, t) for p, t in tree_paths(fo)
                          if any(e and len(e) == 2 for e in spec_of[p]))
        spec = spec_of[path]
        dt = distribute_tensor(leaf, mesh, sharding.to_placements(spec, mesh)).to_local()
        saved["dtensor_equal"] = np.array(torch.equal(dt, sharding.local_shard(leaf, spec, mesh)))
        with sharding.use_sharding(ctx):
            try:
                steps.CompiledTrainStep(cfg, ps, os_)
                saved["refusal"] = np.array("")
            except ValueError as e:
                saved["refusal"] = np.array(str(e))
np.savez(out + f"/rank{{rank}}.npz", **saved)
dist.barrier()                  # no rank tears gloo down while another still talks
dist.destroy_process_group()
"""


def _fill(code):
    inputs = textwrap.dedent(INPUTS).format(B=B, S=S, STEPS=STEPS)
    return textwrap.dedent(code).format(src=SRC, inputs=inputs, MESH=MESH, CASES=CASES,
                                        HYPER=HYPER)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_train")
    r = subprocess.run([sys.executable, "-c", _fill(REFERENCE), str(out)],
                       capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert r.returncode == 0, f"reference:\n{r.stdout}\n{r.stderr[-3000:]}"
    run_world(_fill(RANK), MESH[0] * MESH[1], out)
    ref = {name: dict(np.load(out / f"ref_{name}.npz")) for name in CASES}
    ref["compress"] = dict(np.load(out / "compress.npz"))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(MESH[0] * MESH[1])]
    return ref, ranks


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_compressed_allreduce_is_bit_equal_to_the_reference(runs):
    ref, ranks = runs
    want = ref["compress"]
    exact = want["g"].sum(axis=0, keepdims=True, dtype=np.float64)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["compress/out"], want["out"][r:r + 1])
        np.testing.assert_array_equal(got["compress/out"], want["out"][:1])   # every row equal
        np.testing.assert_allclose(got["compress/err"], want["err"][r:r + 1], rtol=0,
                                   atol=ERROR_ATOL)
    # the reference's own reading (float32 norms), and the port's sum read in float64:
    # 1.012e-02, under the reference test's bound of 0.02
    rel = _rel(ranks[0]["compress/out"], exact)
    assert rel == pytest.approx(float(want["rel"]), rel=1e-5)
    assert abs(rel - 1.012e-02) < 5e-6 and rel < 0.02, rel


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_the_reference_sharded_run(runs, name):
    ref, ranks = runs
    want = ref[name]
    params0 = {k[len("params0/"):]: v for k, v in want.items() if k.startswith("params0/")}
    for r, got in enumerate(ranks):
        for i in range(STEPS):
            for k in ("loss", "ce", "aux", "grad_norm", "lr"):
                np.testing.assert_allclose(got[f"{name}/metrics/{i}/{k}"],
                                           want[f"metrics/{i}/{k}"], rtol=METRIC_RTOL,
                                           atol=1e-12, err_msg=f"rank {r} step {i} {k}")
        for path, p0 in params0.items():
            mine, theirs = got[f"{name}/params/{path}"], want[f"params/{path}"]
            assert _rel(mine - p0, theirs - p0) <= UPDATE_RTOL, (r, path)
            np.testing.assert_array_equal(mine, ranks[0][f"{name}/params/{path}"])
    if name == "moe":
        assert float(want["metrics/0/aux"]) > 1.0


@pytest.mark.parametrize("name", list(CASES) + ["noise"])
def test_each_rank_keeps_the_local_shard_of_the_gathered_params(runs, name):
    _, ranks = runs
    arch, opt = CASES.get(name, ("smollm-360m", "adamw"))
    cfg = get_smoke_config(arch)
    full = {k[len(f"{name}/params/"):]: v for k, v in ranks[0].items()
            if k.startswith(f"{name}/params/")}
    tree = {}
    for k, v in full.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(v)
    spec_of = {"/".join(p): s for p, s in tree_paths(
        tspecs.param_specs(cfg, tree, dict(zip(("data", "model"), MESH)), "train"))}
    assert any(any(e for e in s) for s in spec_of.values())
    for r, got in enumerate(ranks):
        mesh = _StandIn(MESH, got["coords"])
        for path, v in full.items():
            want = layout.local_shard(torch.from_numpy(v), spec_of[path], mesh).numpy()
            np.testing.assert_array_equal(got[f"{name}/shard/{path}"], want, err_msg=path)


def test_sharded_step_with_weight_noise_matches_the_single_process_step(runs):
    """The RRAM noise factors, drawn on the gathered leaves from
    noise_seed(step) on every rank, are the single-process step's."""
    _, ranks = runs
    got = ranks[0]
    for i in range(STEPS):
        for k in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(got[f"noise/metrics/{i}/{k}"], got[f"noise/single/{i}/{k}"],
                                       rtol=METRIC_RTOL, err_msg=f"step {i} {k}")
    dense = {k[len("dense/params/"):]: v for k, v in got.items() if k.startswith("dense/params/")}
    moved = 0
    for path in dense:
        mine, single = got[f"noise/params/{path}"], got[f"noise/single_params/{path}"]
        assert _rel(mine, single) <= 1e-5, path
        moved += not np.array_equal(mine, dense[path])
    assert moved                        # the noise changed the updates


def test_dtensor_placements_cut_as_local_shard_and_the_compiled_step_refuses(runs):
    _, ranks = runs
    for got in ranks:
        assert bool(got["dtensor_equal"])
        assert "cannot be captured" in str(got["refusal"]) and "gloo" in str(got["refusal"])


def _ieee_quantize(x):
    """An IEEE float32 numpy transcription of the reference's
    ``quantize_int8`` (max |x| clamped to 1e-9, / 127, round half to even,
    clip to +-127)."""
    scale = np.maximum(np.abs(x).max(), np.float32(1e-9)) / np.float32(127.0)
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


def test_quantize_and_error_feedback_match_the_reference():
    """One process: ``quantize_int8`` bit-equal to the IEEE transcription;
    against the JAX package, whose XLA divides by 127 as a multiply by its
    reciprocal (ROADMAP hazard 8), the scale within one float32 step and
    the codes equal wherever the scales are; ``compress_with_feedback``,
    ``decompress`` and ``init_error_state`` likewise on a tree."""
    import jax
    import jax.numpy as jnp
    from repro.runtime import compression as jc
    from repro_torch.runtime import compression as tc

    rng = np.random.default_rng(3)
    same_scale = 0
    for _ in range(40):
        x = (rng.standard_normal((37, 53)) * 10 ** rng.uniform(-6, 2)).astype(np.float32)
        tq, ts = tc.quantize_int8(torch.from_numpy(x))
        wq, ws = _ieee_quantize(x)
        np.testing.assert_array_equal(tq.numpy(), wq)
        assert ts.dtype == torch.float32 and ts.numpy() == ws
        jq, js = jax.jit(jc.quantize_int8)(jnp.asarray(x))
        assert abs(float(js) - float(ws)) <= np.spacing(ws)
        if float(js) == float(ws):
            same_scale += 1
            np.testing.assert_array_equal(np.asarray(jq), wq)
    assert same_scale >= 30
    g = {"a": rng.standard_normal((64, 33)).astype(np.float32),
         "b": {"c": rng.standard_normal(7).astype(np.float32) * 1e-4}}
    e = {"a": rng.standard_normal((64, 33)).astype(np.float32) * 1e-3,
         "b": {"c": np.zeros(7, np.float32)}}
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)
                      for k, v in t.items()}
    tqt, terr = tc.compress_with_feedback(to_t(g), to_t(e))
    jqt, jerr = jax.jit(jc.compress_with_feedback)(g, e)
    for path, want in [(("a",), jqt["a"]), (("b", "c"), jqt["b"]["c"])]:
        got = tqt[path[0]] if len(path) == 1 else tqt["b"]["c"]
        assert abs(float(got["scale"]) - float(want["scale"])) <= np.spacing(np.float32(got["scale"]))
        if float(got["scale"]) == float(want["scale"]):
            np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(terr["a"].numpy(), np.asarray(jerr["a"]), rtol=0, atol=1e-6)
    back = tc.decompress(tqt)
    np.testing.assert_array_equal(back["a"].numpy(),
                                  tqt["a"]["q"].numpy().astype(np.float32) * tqt["a"]["scale"].numpy())
    np.testing.assert_allclose(terr["a"].numpy(), g["a"] + e["a"] - back["a"].numpy(), atol=0)
    zero = tc.init_error_state(to_t(g))
    assert zero["b"]["c"].dtype == torch.float32 and not zero["a"].any()


class _StandIn:
    """A (data, model) mesh seen from the rank at ``coords``."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = ("data", "model")
        self.sizes, self.coords = tuple(sizes), tuple(int(c) for c in coords)

    def size(self, dim=None):
        return int(np.prod(self.sizes)) if dim is None else self.sizes[dim]

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


# ---------------------------------------------------------------------------
# The driver as two ranks
# ---------------------------------------------------------------------------

LINE = re.compile(r"^\[rank (\d)\] step +(\d+) loss ([0-9.]+)", re.M)


def _torchrun(tmp_path, *args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--smoke",
           "--device", "cpu", "--seq-len", "64", "--batch", "4", "--log-every", "1",
           "--ckpt-dir", str(tmp_path / "ckpt"), *args]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT, env=env,
                       cwd=tmp_path)
    assert r.returncode == 0, f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    return r.stdout


def test_sharded_driver_survives_a_failure_and_resumes(tmp_path):
    from repro_torch.checkpoint import latest_step
    out = _torchrun(tmp_path, "--steps", "12", "--simulate-failures", "1", "--save-every", "4")
    for r in (0, 1):
        assert f"[rank {r}] [ft] restarted from step 4" in out
        assert f"[rank {r}] arch=smollm-360m-smoke" in out and "data-parallel over 2" in out
    losses = {r: [(int(s), float(x)) for rr, s, x in LINE.findall(out) if int(rr) == r]
              for r in (0, 1)}
    assert losses[0] == losses[1] and len(losses[0]) == 13       # step 5 twice
    assert losses[0][-1][1] < losses[0][0][1]
    # the restart from step 4 repeats step 5 exactly
    assert [x for s, x in losses[0] if s == 5][0] == [x for s, x in losses[0] if s == 5][1]
    assert latest_step(tmp_path / "ckpt") == 12
    out = _torchrun(tmp_path, "--steps", "16", "--save-every", "100")
    assert "[rank 0] restored from checkpoint at step 12" in out
    assert "[rank 1] restored from checkpoint at step 12" in out
    steps = [int(s) for rr, s, _ in LINE.findall(out) if rr == "0"]
    assert steps == [13, 14, 15, 16]


# ---------------------------------------------------------------------------
# On the card: two ranks over gloo
# ---------------------------------------------------------------------------

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
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.runtime import compressed_psum

mesh = init_device_mesh("cuda", (world, 1), mesh_dim_names=("data", "model"))
group = mesh.get_group("data")
g = torch.Generator().manual_seed(rank)
grads = {{"a": torch.randn(300, 129, generator=g) * 1e-3, "b": torch.randn(7, generator=g)}}
errs = {{k: torch.randn(v.shape, generator=g) * 1e-6 for k, v in grads.items()}}
saved = {{}}
for dev in ("cpu", "cuda"):
    o, e = compressed_psum({{k: v.to(dev) for k, v in grads.items()}},
                           {{k: v.to(dev) for k, v in errs.items()}}, group)
    saved.update({{f"{{dev}}/{{k}}": v.cpu() for k, v in {{**o, **{{"e" + k: v for k, v in e.items()}}}}.items()}})
full = torch.randn(8, 6, 4, generator=torch.Generator().manual_seed(9)).cuda()
trips = []
for spec in (sharding.Spec(("data", "model")), sharding.Spec(None, None, "data"),
             sharding.Spec()):
    shard = sharding.local_shard(full, spec, mesh)
    back = sharding.gather_shard(shard, spec, mesh, full.shape)
    trips.append(bool(shard.is_cuda and back.is_cuda and torch.equal(back, full)))
saved["trips"] = trips
cfg = get_smoke_config("smollm-360m")
params, state = steps.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0))
ctx = sharding.ShardingCtx(mesh, sharding.activation_rules(cfg, mesh, "train"))
with sharding.use_sharding(ctx):
    try:
        steps.CompiledTrainStep(cfg, params, state)
        saved["refusal"] = ""
    except ValueError as e:
        saved["refusal"] = str(e)
torch.save(saved, f"{{out}}/gpu{{rank}}.pt")
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gpu_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = tmp_path_factory.mktemp("dp_gpu")
    run_world(textwrap.dedent(GPU_RANK).format(src=SRC), 2, out)
    return [torch.load(out / f"gpu{r}.pt") for r in range(2)]


@pytest.mark.gpu
def test_compressed_psum_on_cuda_is_bit_equal_to_the_cpu_call(gpu_world):
    for got in gpu_world:
        keys = [k[4:] for k in got if k.startswith("cpu/")]
        assert set(keys) == {"a", "b", "ea", "eb"}
        for k in keys:
            assert torch.equal(got[f"cuda/{k}"].view(torch.int32),
                               got[f"cpu/{k}"].view(torch.int32)), k
    assert torch.equal(gpu_world[0]["cuda/a"], gpu_world[1]["cuda/a"])


@pytest.mark.gpu
def test_local_and_gather_shard_round_trip_on_cuda(gpu_world):
    for got in gpu_world:
        assert got["trips"] == [True, True, True]


@pytest.mark.gpu
def test_compiled_train_step_refuses_a_gloo_data_parallel_context(gpu_world):
    for got in gpu_world:
        assert "cannot be captured" in got["refusal"] and "gloo" in got["refusal"]
