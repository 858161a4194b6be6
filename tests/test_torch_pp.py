"""The pipeline of the port (ROADMAP §A6d): ``models.run_groups`` (a
range of layer groups), ``sharding.ppermute`` (the hand-off) and
``launch.pipeline`` (``stage_param_specs`` / ``pp_specs``,
``strip_axis``, ``pp_forward``, ``make_pp_train_step``), held to the JAX
package's ``repro.launch.pipeline``.

- One process: the stage specs and ``strip_axis`` against the
  reference's for every arch; ``run_groups`` over two half ranges in turn
  bit-equal to the whole range; the refusals.
- JAX subprocesses (two at once) with 8 host devices run the reference on an
  ``Auto``-axes (2, 2, 2) ("pod", "data", "model") mesh (ROADMAP hazard
  1): ``pp_forward`` and 3 steps of ``make_pp_train_step`` with 4
  microbatches, global B8 x S32 made by numpy, float32, for smollm-360m
  smoke at 4 layers (the reference test's config), mixtral-8x7b smoke
  (MoE, window), mamba2 smoke, zamba2 smoke at 2 groups (the shared block
  replicated) and smollm with Adafactor (remat on); each
  non-MoE config also unpipelined (``make_train_step``), the reference's
  own spread between the two schedules.
- One world of 8 torch ranks over gloo (a file store in tmp_path, one
  process a rank) runs the port's pipeline from the same weights.
- One world of 2 ranks on a (2, 1, 1) mesh (run beside the JAX
  subprocesses) holds the port's pipelined loss, gradients and 3 train steps
  to its own single-process ``make_loss_fn`` / ``make_train_step`` for the
  non-MoE families, and ``ppermute``'s forward and backward.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import pipeline as pp
from repro_torch.sharding import Spec, activation_rules
from repro_torch.tree import tree_map, tree_paths
from test_torch_picnic import run_world
from test_torch_sp import _finish_world, _start_world

SRC = str(Path(__file__).resolve().parents[1] / "src")
RUN_TIMEOUT = 240                    # seconds, each subprocess
# the metrics of a step: float32 sums in another order (the stages' and
# the data-parallel sums, XLA's fused reductions)
METRIC_RTOL = 1e-5
# each leaf's update after 3 steps, relative L2 (tests/test_torch_train.py's
# UPDATE_RTOL; ROADMAP hazard 10)
UPDATE_RTOL = 1e-3
# the pipelined loss and gradients against the port's single-process ones
SINGLE_RTOL = 1e-5
MESH = (2, 2, 2)
AXES = ("pod", "data", "model")
B, S, STEPS, N_MICRO = 8, 32, 3, 4
HYPER = dict(warmup=1, total_steps=10)
CASES = {"dense": ("smollm-360m", {"n_layers": 4}),
         "moe": ("mixtral-8x7b", {}),
         "ssm": ("mamba2-2.7b", {}),
         "hybrid": ("zamba2-2.7b", {"n_layers": 12}),
         "adafactor": ("smollm-360m", {"n_layers": 4, "optimizer": "adafactor",
                                       "remat": True})}
# the reference's cases in two subprocesses at once (zamba2's compiles take
# ~half the time)
REFERENCE_SPLIT = (("hybrid", "adafactor"), ("dense", "moe", "ssm"))
# the 2-rank world's cases: the families without an aux loss
SINGLE = {"dense": ("smollm-360m", {"n_layers": 4}),
          "dense_remat": ("smollm-360m", {"n_layers": 4, "remat": True}),
          "ssm": ("mamba2-2.7b", {}),
          "hybrid": ("zamba2-2.7b", {"n_layers": 12})}

INPUTS = """
def batches(vocab):
    g = np.random.default_rng(1)
    return [g.integers(0, vocab, ({B}, {S})).astype(np.int32) for _ in range({STEPS})]
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
from repro.launch.pipeline import make_pp_train_step, pp_forward
from repro.launch.steps import make_train_step
{inputs}
out = sys.argv[1]
assert len(jax.devices()) == 8
mesh = jax.make_mesh({MESH}, {AXES}, axis_types=(AxisType.Auto,) * 3)

def flat(tree):
    return {{"/".join(str(k.key) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}}

for name in sys.argv[2].split(","):
    arch, extra = {CASES!r}[name]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **extra)
    params = models.init_params(cfg, jax.random.PRNGKey(0))
    state = optim.make_optimizer(cfg.optimizer)[0](params)
    toks = [jnp.asarray(t) for t in batches(cfg.vocab_size)]
    loss, aux = jax.jit(lambda p, t: pp_forward(cfg, p, t, mesh=mesh, n_micro={N_MICRO}))(
        params, toks[0])
    saved = {{"params0/" + k: v for k, v in flat(params).items()}}
    saved.update({{"forward/loss": np.asarray(loss), "forward/aux": np.asarray(aux)}})
    step = jax.jit(make_pp_train_step(cfg, mesh, n_micro={N_MICRO}, **{HYPER!r}))
    p, o = params, state
    for i, t in enumerate(toks):
        p, o, m = step(p, o, t)
        saved.update({{f"metrics/{{i}}/{{k}}": np.asarray(v) for k, v in m.items()}})
    saved.update({{"params/" + k: v for k, v in flat(p).items()}})
    if cfg.family != "moe":     # the same function unpipelined: the reference's own spread
        step = jax.jit(make_train_step(cfg, **{HYPER!r}))
        p, o = params, state
        for t in toks:
            p, o, _ = step(p, o, {{"tokens": t, "labels": jnp.roll(t, -1, 1)}})
        saved.update({{"unpiped/" + k: v for k, v in flat(p).items()}})
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
from repro_torch.configs import get_smoke_config
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps
from repro_torch.optim import make_optimizer
from repro_torch.params import from_jax
from repro_torch.tree import tree_from_paths, tree_paths
{inputs}
mesh = init_device_mesh("cpu", {MESH}, mesh_dim_names={AXES})
saved = {{}}
for name, (arch, extra) in {CASES!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **extra)
    ref = np.load(out + f"/ref_{{name}}.npz")
    params = from_jax(tree_from_paths((tuple(k.split("/")[1:]), v) for k, v in ref.items()
                                      if k.startswith("params0/")), "cpu")
    state = make_optimizer(cfg.optimizer)[0](params)
    pspecs = pp.pp_specs(cfg, params, mesh)
    ospecs = pp.pp_opt_state_specs(cfg, state)
    ps, os_ = steps.shard_train_state(params, state, pspecs, ospecs, mesh)
    toks = [torch.from_numpy(t).long() for t in batches(cfg.vocab_size)]
    loss, aux = pp.pp_forward(cfg, ps, toks[0], mesh=mesh, n_micro={N_MICRO})
    saved.update({{f"{{name}}/forward/loss": loss.numpy(), f"{{name}}/forward/aux": aux.numpy()}})
    step = pp.make_pp_train_step(cfg, mesh, n_micro={N_MICRO}, **{HYPER!r})
    for i, t in enumerate(toks):
        ps, os_, m = step(ps, os_, t)
        saved.update({{f"{{name}}/metrics/{{i}}/{{k}}": v.numpy() for k, v in m.items()}})
    fp, _ = steps.gather_train_state(ps, os_, pspecs, ospecs, mesh)
    spec_of = dict(tree_paths(pspecs))
    for path, t in tree_paths(fp):
        saved[f"{{name}}/params/{{'/'.join(path)}}"] = t.numpy()
    for path, t in tree_paths(ps):             # the replicated leaves as the rank holds them
        if not any(spec_of[path]):
            saved[f"{{name}}/local/{{'/'.join(path)}}"] = t.numpy()
np.savez(out + f"/rank{{rank}}.npz", **saved)
dist.barrier()                  # no rank tears gloo down while another still talks
dist.destroy_process_group()
"""

SINGLE_RANK = """
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
from repro_torch import sharding
from repro_torch.configs import get_smoke_config
from repro_torch.launch import pipeline as pp
from repro_torch.launch import steps
from repro_torch.tree import tree_paths
{inputs}
mesh = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names={AXES})
saved = {{}}

def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))

for name, (arch, extra) in {SINGLE!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", **extra)
    toks = [torch.from_numpy(t).long() for t in batches(cfg.vocab_size)]
    batch = lambda t: {{"tokens": t, "labels": t.roll(-1, 1)}}
    params, state = steps.init_train_state(cfg, torch.Generator().manual_seed(0))
    p0 = {{path: t.detach().clone() for path, t in tree_paths(params)}}
    loss1, parts = steps.make_loss_fn(cfg)(params, batch(toks[0]))
    g1 = torch.autograd.grad(loss1, [t for _, t in tree_paths(params)])
    pspecs = pp.pp_specs(cfg, params, mesh)
    ospecs = pp.pp_opt_state_specs(cfg, state)
    ps, os_ = steps.shard_train_state(params, state, pspecs, ospecs, mesh)
    fwd, _ = pp.pp_forward(cfg, ps, toks[0], mesh=mesh, n_micro={N_MICRO})
    loss, aux, grads = pp.pp_loss_and_grads(cfg, ps, toks[0], mesh=mesh, n_micro={N_MICRO})
    saved[f"{{name}}/loss"] = np.array([float(loss1), float(fwd), float(loss)])
    saved[f"{{name}}/aux"] = np.array([float(parts["aux"]), float(aux)])
    saved[f"{{name}}/grad_rel"] = np.array([
        rel(sharding.gather_shard(g, spec, mesh, sharding.full_shape(g.shape, spec, mesh)), want)
        for (_, g), (_, spec), want in zip(tree_paths(grads), tree_paths(pspecs), g1)])
    single = steps.make_train_step(cfg, **{HYPER!r})
    step = pp.make_pp_train_step(cfg, mesh, n_micro={N_MICRO}, **{HYPER!r})
    for i, t in enumerate(toks):
        params, state, m1 = single(params, state, batch(t))
        ps, os_, m = step(ps, os_, t)
        saved[f"{{name}}/metrics/{{i}}"] = np.array(
            [[float(m1["ce"]), float(m["loss"])], [float(m1["grad_norm"]), float(m["grad_norm"])]])
    fp, _ = steps.gather_train_state(ps, os_, pspecs, ospecs, mesh)
    saved[f"{{name}}/update_rel"] = np.array([
        rel(t - p0[path], single_t.detach() - p0[path])
        for (path, t), (_, single_t) in zip(tree_paths(fp), tree_paths(params))])

# the hand-off: forward along the pairs, the gradient back along them reversed
x = torch.full((3, 4), float(rank + 1), requires_grad=True)
w = torch.arange(12.0).reshape(3, 4) * (rank + 1)
y = sharding.ppermute(x, mesh, "pod", [(0, 1)])
(y * w).sum().backward()
saved["handoff/y"], saved["handoff/dx"] = y.detach().numpy(), x.grad.numpy()
saved["handoff/swap"] = sharding.ppermute(x.detach(), mesh, "pod", [(0, 1), (1, 0)]).numpy()
bf16 = sharding.ppermute(torch.full((2, 5), rank + 0.5, dtype=torch.bfloat16), mesh, "pod",
                         [(1, 0)])
saved["handoff/bf16"] = np.array([bf16.dtype == torch.bfloat16, float(bf16.float().sum())])
try:
    sharding.ppermute(x.detach(), mesh, "pod", [(0, 1), (1, 1)])
    saved["handoff/refusal"] = np.array("")
except ValueError as e:
    saved["handoff/refusal"] = np.array(str(e))
np.savez(out + f"/single{{rank}}.npz", **saved)
dist.barrier()
dist.destroy_process_group()
"""


def _fill(code):
    inputs = textwrap.dedent(INPUTS).format(B=B, S=S, STEPS=STEPS)
    return textwrap.dedent(code).format(src=SRC, inputs=inputs, MESH=MESH, AXES=AXES,
                                        CASES=CASES, SINGLE=SINGLE, HYPER=HYPER,
                                        N_MICRO=N_MICRO)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocesses, then the 8-rank world; the 2-rank world
    runs beside the reference (it needs none of its numbers)."""
    out = tmp_path_factory.mktemp("pp")
    own = out / "single"
    own.mkdir()
    world2 = _start_world(_fill(SINGLE_RANK), 2, own)
    refs = [subprocess.Popen([sys.executable, "-c", _fill(REFERENCE), str(out), ",".join(names)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for names in REFERENCE_SPLIT]
    try:
        for names, r in zip(REFERENCE_SPLIT, refs):
            text = r.communicate(timeout=RUN_TIMEOUT)[0]
            assert r.returncode == 0, f"reference {names}:\n{text[-3000:]}"
        run_world(_fill(RANK), int(np.prod(MESH)), out)
    finally:
        for r in refs:
            if r.poll() is None:
                r.kill()
                r.wait()
        _finish_world(world2)
    ref = {name: dict(np.load(out / f"ref_{name}.npz")) for name in CASES}
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(int(np.prod(MESH)))]
    singles = [dict(np.load(own / f"single{r}.npz")) for r in range(2)]
    return ref, ranks, singles


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# Against the reference's pipelined run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_pp_forward_matches_the_reference(runs, name):
    ref, ranks, _ = runs
    for r, got in enumerate(ranks):
        for k in ("loss", "aux"):
            np.testing.assert_allclose(got[f"{name}/forward/{k}"], ref[name][f"forward/{k}"],
                                       rtol=METRIC_RTOL, atol=1e-12, err_msg=f"rank {r} {k}")
    if name == "moe":
        assert float(ref[name]["forward/aux"]) > 1.0


@pytest.mark.parametrize("name", list(CASES))
def test_pp_train_step_matches_the_reference(runs, name):
    ref, ranks, _ = runs
    want = ref[name]
    params0 = {k[len("params0/"):]: v for k, v in want.items() if k.startswith("params0/")}
    for r, got in enumerate(ranks):
        for i in range(STEPS):
            for k in ("loss", "aux", "grad_norm"):
                np.testing.assert_allclose(got[f"{name}/metrics/{i}/{k}"],
                                           want[f"metrics/{i}/{k}"], rtol=METRIC_RTOL,
                                           atol=1e-12, err_msg=f"rank {r} step {i} {k}")
            assert set(k.split("/")[-1] for k in got if k.startswith(f"{name}/metrics/{i}/")) \
                == {"loss", "aux", "grad_norm"}
        for path, p0 in params0.items():
            mine, theirs = got[f"{name}/params/{path}"], want[f"params/{path}"]
            assert _rel(mine - p0, theirs - p0) <= _update_bar(want, path), (r, path)


def _update_bar(want, path):
    """A leaf's bar on its update against the reference's pipelined run:
    UPDATE_RTOL, or twice the reference's own spread on that leaf between
    its pipelined and unpipelined runs where that is larger (hazard 10:
    AdamW divides the rounding of near-zero gradients by their own size,
    and the schedule's other order of sums alone moves zamba2's embed by
    1.35e-3 in the reference).  A MoE run has no unpipelined counterpart:
    its aux loss is each microbatch's."""
    if f"unpiped/{path}" not in want:
        return UPDATE_RTOL
    p0, theirs = want[f"params0/{path}"], want[f"params/{path}"]
    return max(UPDATE_RTOL, 2 * _rel(want[f"unpiped/{path}"] - p0, theirs - p0))


def test_the_update_bar_widens_only_where_the_reference_differs_from_itself(runs):
    """Every leaf's bar is UPDATE_RTOL but zamba2's embed, where the
    reference's pipelined and unpipelined runs lie 1e-3 or more apart."""
    ref, _, _ = runs
    assert "unpiped/embed" not in ref["moe"]
    wide = {(name, k[len("params0/"):]) for name, want in ref.items()
            for k in want if k.startswith("params0/")
            and _update_bar(want, k[len("params0/"):]) > UPDATE_RTOL}
    assert wide == {("hybrid", "embed")}, wide
    assert 2 * UPDATE_RTOL < _update_bar(ref["hybrid"], "embed") < 4 * UPDATE_RTOL


@pytest.mark.parametrize("name", list(CASES))
def test_replicated_leaves_stay_bit_equal_on_every_rank(runs, name):
    _, ranks, _ = runs
    local = [k for k in ranks[0] if k.startswith(f"{name}/local/")]
    assert any(k.endswith("/embed") for k in local)
    if name == "hybrid":
        assert any("/shared_attn/" in k for k in local)
    for got in ranks[1:]:
        for k in local:
            np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=k)
        for k in ranks[0]:
            if k.startswith(f"{name}/params/"):
                np.testing.assert_array_equal(got[k], ranks[0][k], err_msg=k)


# ---------------------------------------------------------------------------
# Against the port's own single-process loss and step (2 ranks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(SINGLE))
def test_pp_loss_and_grads_match_the_single_process_ones(runs, name):
    _, _, singles = runs
    for got in singles:
        single, fwd, loss = got[f"{name}/loss"]
        assert abs(fwd - single) <= SINGLE_RTOL * abs(single)
        assert abs(loss - single) <= SINGLE_RTOL * abs(single)
        assert tuple(got[f"{name}/aux"]) == (0.0, 0.0)
        assert got[f"{name}/grad_rel"].max() <= SINGLE_RTOL, got[f"{name}/grad_rel"]
    np.testing.assert_array_equal(singles[0][f"{name}/grad_rel"], singles[1][f"{name}/grad_rel"])


@pytest.mark.parametrize("name", list(SINGLE))
def test_pp_train_steps_match_the_single_process_steps(runs, name):
    _, _, singles = runs
    got = singles[0]
    for i in range(STEPS):
        (ce1, loss), (gn1, gn) = got[f"{name}/metrics/{i}"]
        assert abs(loss - ce1) <= METRIC_RTOL * abs(ce1), (i, loss, ce1)
        assert abs(gn - gn1) <= METRIC_RTOL * abs(gn1), (i, gn, gn1)
    assert got[f"{name}/update_rel"].max() <= UPDATE_RTOL, got[f"{name}/update_rel"]
    np.testing.assert_array_equal(got[f"{name}/metrics/{STEPS - 1}"],
                                  singles[1][f"{name}/metrics/{STEPS - 1}"])


def test_ppermute_hands_off_forward_and_its_gradient_back(runs):
    _, _, singles = runs
    w = np.arange(12.0).reshape(3, 4)
    # rank 0 is a source only: it receives zeros, and the gradient of rank 1's w
    np.testing.assert_array_equal(singles[0]["handoff/y"], np.zeros((3, 4)))
    np.testing.assert_array_equal(singles[0]["handoff/dx"], w * 2)
    np.testing.assert_array_equal(singles[1]["handoff/y"], np.full((3, 4), 1.0))
    np.testing.assert_array_equal(singles[1]["handoff/dx"], np.zeros((3, 4)))
    np.testing.assert_array_equal(singles[0]["handoff/swap"], np.full((3, 4), 2.0))
    np.testing.assert_array_equal(singles[1]["handoff/swap"], np.full((3, 4), 1.0))
    assert tuple(singles[0]["handoff/bf16"]) == (1.0, 15.0)      # rank 1's 1.5 x 10
    assert tuple(singles[1]["handoff/bf16"]) == (1.0, 0.0)
    for got in singles:
        assert "not a partial permutation" in str(got["handoff/refusal"])


# ---------------------------------------------------------------------------
# One process: specs, the group-range runner, refusals
# ---------------------------------------------------------------------------

def _norm(spec):
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


@pytest.mark.parametrize("arch", list_archs())
def test_stage_specs_match_the_reference(arch):
    """``stage_param_specs`` / ``pp_specs`` and ``pp_opt_state_specs``
    against the reference's ``_stage_param_specs`` on the full-size shape
    trees (``jax.eval_shape``), every arch."""
    import jax
    from jax.sharding import PartitionSpec
    from repro import models as jmodels
    from repro.configs import get_config as jget_config
    from repro.launch.pipeline import _stage_param_specs
    jcfg = jget_config(arch)
    shapes = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k), jax.random.PRNGKey(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(
        _stage_param_specs(shapes, "pod"), is_leaf=lambda x: isinstance(x, PartitionSpec))
    want = {tuple(str(k.key) for k in path): _norm(s) for path, s in flat}
    tree = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        node = tree
        keys = [str(k.key) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(leaf.shape, device="meta")
    cfg = get_config(arch)
    got = {path: tuple(s) for path, s in tree_paths(
        pp.pp_specs(cfg, tree, dict(zip(AXES, MESH))))}
    assert got == want
    assert any(got.values()) and (("pod",),) in got.values()
    # AdamW's moments cut as their params, Adafactor's state whole
    from repro_torch.optim import adafactor_init, adamw_init
    adamw = pp.pp_opt_state_specs(dataclasses.replace(cfg, optimizer="adamw"),
                                  adamw_init(tree))
    assert {p[1:]: tuple(s) for p, s in tree_paths(adamw) if p[0] == "m"} == got
    assert tuple(adamw["step"]) == ()
    cfg_af = dataclasses.replace(cfg, optimizer="adafactor")
    assert all(s == Spec() for _, s in tree_paths(pp.pp_opt_state_specs(cfg_af,
                                                                         adafactor_init(tree))))


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("axis", ["pod", "model"])
def test_strip_axis_matches_the_reference(mode, axis):
    import jax
    from repro.configs import get_config as jget_config
    from repro.launch.pipeline import strip_axis as jstrip
    from repro.sharding import specs as jspecs
    from types import SimpleNamespace
    shape = dict(zip(AXES, MESH))
    for arch in ("llama3.2-1b", "mixtral-8x7b"):
        want = jstrip(jspecs.activation_rules(jget_config(arch), SimpleNamespace(shape=shape),
                                              mode), axis)
        got = pp.strip_axis(activation_rules(get_config(arch), shape, mode), axis)
        assert set(got) == set(want)
        for role in want:
            assert isinstance(got[role], Spec)
            assert tuple(got[role]) == _norm(want[role]), (arch, role)
    assert pp.strip_axis({"a": Spec(("pod",), None, ("pod", "data"))}, "pod") == \
        {"a": Spec(None, None, "data")}


class _StandIn:
    """A mesh of named axes with this rank's coordinates on them."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = tuple(sizes)
        self.sizes, self.coords = tuple(sizes.values()), tuple(coords)

    def size(self, dim=None):
        return int(np.prod(self.sizes)) if dim is None else self.sizes[dim]

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


def test_the_pipeline_refuses_what_the_reference_does_not_define():
    mesh = _StandIn(dict(zip(AXES, MESH)), (0, 0, 0))
    dense = dataclasses.replace(get_smoke_config("smollm-360m"), dtype="float32")
    params = models.init_params(dense, torch.Generator().manual_seed(0))
    toks = torch.zeros(8, 16, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="§A6d"):
        pp.pp_forward(dense, params, toks, mesh=mesh, partial_manual=True)
    for arch in ("whisper-large-v3", "paligemma-3b"):
        with pytest.raises(ValueError, match="embeds tokens only"):
            pp.make_pp_train_step(get_smoke_config(arch), mesh)
    with pytest.raises(ValueError, match="do not split into 4 stages"):
        pp.make_pp_train_step(dataclasses.replace(dense, n_layers=6),
                              {"pod": 4, "data": 1, "model": 1})
    with pytest.raises(ValueError, match="no stage axis"):
        pp.make_pp_train_step(dense, {"data": 2, "model": 4})
    # B 12 over data 2: 6 rows a rank, not 4 microbatches; B 10 does not cut over
    # data, and 10 rows are not 4 microbatches either
    for b in (12, 10):
        with pytest.raises(ValueError, match="does not split into 4 microbatches"):
            pp.pp_forward(dense, params, torch.zeros(b, 16, dtype=torch.long), mesh=mesh)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch,extra", [("smollm-360m", {"n_layers": 4}),
                                        ("zamba2-2.7b", {"n_layers": 12})])
def test_run_groups_over_two_half_ranges_equals_the_whole(arch, extra, remat):
    """``run_groups`` on the first half of the groups, then the second,
    gives the whole range's output and gradients bit for bit, the shared
    block's (zamba2) included."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", remat=remat, **extra)
    params = tree_map(lambda t: t.requires_grad_(True),
                      models.init_params(cfg, torch.Generator().manual_seed(0)))
    _, n_groups = models.group_layout(cfg)
    h = n_groups // 2
    x0 = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    positions = torch.arange(16)
    shared = {"shared_attn": params["shared_attn"]} if "shared_attn" in params else {}
    leaves = [t for _, t in tree_paths(params["layers"])] + \
        [t for _, t in tree_paths(shared)]

    def run(ranges):
        x = x0.clone().requires_grad_(True)
        y = x
        for lo, hi in ranges:
            stage = {"layers": tree_map(lambda t: t[lo:hi], params["layers"]), **shared}
            y, aux = models.run_groups(cfg, stage, y, positions)
        grads = torch.autograd.grad(y.square().mean(), [x] + leaves, allow_unused=True)
        return y.detach(), grads

    whole, gw = run([(0, n_groups)])
    halves, gh = run([(0, h), (h, n_groups)])
    assert torch.equal(whole, halves)
    for a, b in zip(gw, gh):
        assert (a is None and b is None) or torch.equal(a, b)
    # forward's logits are the whole range's, through the head
    logits, _, _ = models.forward(cfg, params, torch.zeros(1, 8, dtype=torch.long))
    assert logits.shape == (1, 8, cfg.vocab_size) and torch.isfinite(logits).all()
