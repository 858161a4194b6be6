"""The port's sharding specs (``repro_torch.sharding.specs``) and cuts
(``sharding.layout.local_shard``) against the JAX package's
``repro.sharding.specs``, on the CPU without a process group.

- Smoke size, the port's own trees: for every arch of the registry, its
  params, AdamW and Adafactor state, ``init_cache`` and batches against
  the reference's trees (``jax.eval_shape``): ``param_specs`` in the three
  modes with ``mlp_tp`` both ways, ``opt_state_specs``, ``cache_specs``
  with ``long_context`` both ways, ``batch_specs`` and
  ``activation_rules``, on ``{data: 2, model: 4}``, ``{data: 16, model:
  16}`` and ``{pod: 2, data: 16, model: 16}``.  The spec functions read
  only a mesh's axis sizes, so the meshes are plain mappings here (the
  reference's a stand-in with a ``shape``).
- Full size: the same on shape trees, meta tensors of the reference's
  ``jax.eval_shape`` shapes (the port's optimizer state and cache made by
  its own init functions on the meta device).
- Layout: one subprocess with 8 host devices puts a smoke tree on an
  ``Auto`` (2, 4) mesh by ``to_named`` of the reference's specs; each
  device's shard equals the port's ``local_shard`` at the same mesh
  coordinates, bit for bit.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import repro.configs as jconfigs
import repro.models as jmodels
from repro import optim as joptim
from repro.sharding import specs as jspecs
import repro_torch.configs as tconfigs
from repro_torch import models as tmodels
from repro_torch import optim as toptim
from repro_torch.sharding import layout, specs as tspecs
from repro_torch.tree import tree_from_paths, tree_paths

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = tconfigs.list_archs()
MESHES = {"2x4": {"data": 2, "model": 4}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = [("train", False), ("train", True), ("prefill", False), ("prefill", True),
         ("decode", False), ("decode", True)]
# (batch, cache rows): batches that split over every dp axis, over "data"
# only on the two-pod mesh, and over none; rows that split over both axes
# of a pod (256) or over "model" only
CACHE_SHAPES = [(32, 512), (16, 96), (3, 64)]
BATCHES = [32, 16, 3]
RUN_TIMEOUT = 240                    # seconds, the layout subprocess


def _norm(spec):
    """A spec of either package as a tuple: each entry None or a tuple of
    axis names (JAX writes ``("data",)`` as ``"data"``)."""
    return tuple(None if e is None else (e,) if isinstance(e, str) else tuple(e)
                 for e in spec)


def _ref_flat(tree):
    """{key path: normalised spec} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {tuple(str(k.key) for k in path): _norm(s) for path, s in flat}


def _port_flat(tree):
    out = {}
    for path, s in tree_paths(tree):
        assert isinstance(s, tspecs.Spec), (path, s)
        out[path] = tuple(s)
    return out


def _ref_mesh(shape):
    return SimpleNamespace(shape=dict(shape))


def _meta(tree):
    """Meta tensors of a tree of shapes (``jax.ShapeDtypeStruct``)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tuple(tree.shape), device="meta")


def _batch_shapes(cfg, b, s):
    out = {"tokens": (b, s), "labels": (b, s), "mask": (b, s)}
    if cfg.n_prefix_tokens:
        out["prefix_embeds"] = (b, cfg.n_prefix_tokens, cfg.d_model)
    if cfg.is_encoder_decoder:
        out["encoder_embeds"] = (b, cfg.encoder_seq, cfg.d_model)
    return out


def _check_all(jcfg, tcfg, jparams, tparams, cache_of):
    """Every spec function of both packages on the two trees of each kind,
    on every mesh; ``cache_of(b, s)`` -> (reference cache shapes, port
    cache)."""
    for opt in ("adamw", "adafactor"):
        init_j, _ = joptim.make_optimizer(opt)
        init_t, _ = toptim.make_optimizer(opt)
        jopt = jax.eval_shape(init_j, jparams)
        topt = init_t(tparams)
        for name, shape in MESHES.items():
            jm = _ref_mesh(shape)
            for mode, mlp_tp in MODES:
                jp = jspecs.param_specs(jcfg, jparams, jm, mode, mlp_tp=mlp_tp)
                tp = tspecs.param_specs(tcfg, tparams, shape, mode, mlp_tp=mlp_tp)
                assert _port_flat(tp) == _ref_flat(jp), (name, mode, mlp_tp)
            jo = jspecs.opt_state_specs(jcfg, jopt, jp, jm)
            to = tspecs.opt_state_specs(tcfg, topt, tp, shape)
            assert _port_flat(to) == _ref_flat(jo), (name, opt)
    for name, shape in MESHES.items():
        jm = _ref_mesh(shape)
        for b, s in CACHE_SHAPES:
            jc, tc = cache_of(b, s)
            for long_context in (False, True):
                want = _ref_flat(jspecs.cache_specs(jcfg, jc, jm, long_context=long_context))
                got = _port_flat(tspecs.cache_specs(tcfg, tc, shape, long_context=long_context))
                assert got == want, (name, b, s, long_context)
        for b in BATCHES:
            shapes = _batch_shapes(tcfg, b, 64)
            jb = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
            tb = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
            assert _port_flat(tspecs.batch_specs(tcfg, tb, shape)) == \
                _ref_flat(jspecs.batch_specs(jcfg, jb, jm)), (name, b)
        for mode in ("train", "prefill", "decode"):
            for long_context in (False, True):
                want = jspecs.activation_rules(jcfg, jm, mode, long_context=long_context)
                got = tspecs.activation_rules(tcfg, shape, mode, long_context=long_context)
                assert set(got) == set(want)
                for role in want:
                    assert isinstance(got[role], tspecs.Spec)
                    assert tuple(got[role]) == _norm(want[role]), (name, mode, role)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference_on_the_ports_smoke_trees(arch):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32")
    jparams = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k), jax.random.PRNGKey(0))
    tparams = tmodels.init_params(tcfg, torch.Generator().manual_seed(0))

    def cache_of(b, s):
        return (jax.eval_shape(lambda: jmodels.init_cache(jcfg, b, s)),
                tmodels.init_cache(tcfg, b, s))

    _check_all(jcfg, tcfg, jparams, tparams, cache_of)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_the_reference_at_full_size_on_meta_trees(arch):
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jparams = jax.eval_shape(lambda k: jmodels.init_params(jcfg, k), jax.random.PRNGKey(0))
    tparams = _meta(jparams)

    def cache_of(b, s):
        return (jax.eval_shape(lambda: jmodels.init_cache(jcfg, b, s)),
                tmodels.init_cache(tcfg, b, s, device="meta"))

    _check_all(jcfg, tcfg, jparams, tparams, cache_of)


def test_spec_entries_are_normalised():
    S = tspecs.Spec
    assert S("model") == S(("model",)) == (("model",),)
    assert S(("data", "model"), None, "model") == (("data", "model"), None, ("model",))
    assert S() == ()
    assert tspecs._spec_with(4, {1: ("data",)}) == S(None, "data")      # trailing Nones cut
    assert tspecs._best_dim((64, 64, 32), set(), 32) == 0               # strict >: the first


def test_the_mesh_is_read_from_a_device_mesh_or_a_mapping():
    standin = _StandIn({"data": 2, "model": 4}, (1, 3))
    assert tspecs.mesh_shape(standin) == {"data": 2, "model": 4}
    assert tspecs.dp_axes(MESHES["2x16x16"]) == ("pod", "data")
    assert tspecs.dp_axes(standin) == ("data",)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _StandIn({"data": 2, "model": 4}, (0, 0))
    S = tspecs.Spec
    assert tspecs.to_placements(S(None, ("data", "model")), mesh) == (Shard(1), Shard(1))
    assert tspecs.to_placements(S("model", "data"), mesh) == (Shard(1), Shard(0))
    assert tspecs.to_placements(S(), mesh) == (Replicate(), Replicate())
    assert tspecs.to_placements({"a": S("data")}, mesh) == {"a": (Shard(0), Replicate())}
    with pytest.raises(ValueError, match="order"):
        tspecs.to_placements(S(("model", "data")), mesh)


# ---------------------------------------------------------------------------
# Layout: local_shard against JAX's addressable shards
# ---------------------------------------------------------------------------

class _StandIn:
    """A mesh of named axes with this rank's coordinates on them: what
    ``local_shard`` reads of a ``DeviceMesh``."""

    def __init__(self, sizes, coords):
        self.mesh_dim_names = tuple(sizes)
        self.sizes = tuple(sizes.values())
        self.coords = tuple(coords)

    def size(self, dim=None):
        return int(np.prod(self.sizes)) if dim is None else self.sizes[dim]

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


LAYOUT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import sys
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType
from repro import models, optim
from repro.configs import get_smoke_config
from repro.sharding import specs as sp

out = sys.argv[1]
assert len(jax.devices()) == 8
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
cfg = dataclasses.replace(get_smoke_config("mixtral-8x7b"), dtype="float32")
params = models.init_params(cfg, jax.random.PRNGKey(0))
opt = optim.make_optimizer("adamw")[0](params)
opt = jax.tree.map(lambda t: t + jax.random.normal(jax.random.PRNGKey(2), t.shape), opt)
cache = jax.tree.map(lambda t: jax.random.normal(jax.random.PRNGKey(3), t.shape),
                     models.init_cache(cfg, 3, 64))     # B3: the batch stays whole
trees = {{"train": (params, sp.param_specs(cfg, params, mesh, "train")),
          "decode": (params, sp.param_specs(cfg, params, mesh, "decode")),
          "opt": (opt, sp.opt_state_specs(cfg, opt, None, mesh)),
          "cache": (cache, sp.cache_specs(cfg, cache, mesh, long_context=True))}}
saved = {{}}
for name, (tree, specs) in trees.items():
    placed = jax.device_put(tree, sp.to_named(specs, mesh))
    for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
        key = "/".join(str(k.key) for k in path)
        saved[f"{{name}}/{{key}}/full"] = np.asarray(arr)
        for shard in arr.addressable_shards:
            (i, j), = np.argwhere(mesh.devices == shard.device)
            saved[f"{{name}}/{{key}}/{{i}}{{j}}"] = np.asarray(shard.data)
np.savez(out + "/shards.npz", **saved)
print("layout ok")
"""


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    out = tmp_path_factory.mktemp("layout")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(LAYOUT).format(src=SRC), str(out)],
                       capture_output=True, text=True, timeout=RUN_TIMEOUT)
    assert r.returncode == 0, f"reference:\n{r.stdout}\n{r.stderr[-3000:]}"
    with np.load(out / "shards.npz") as f:
        return dict(f)


@pytest.mark.parametrize("name", ["train", "decode", "opt", "cache"])
def test_local_shard_equals_jax_addressable_shards(jax_shards, name):
    cfg = dataclasses.replace(tconfigs.get_smoke_config("mixtral-8x7b"), dtype="float32")
    full = tree_from_paths((tuple(k.split("/")[1:-1]), torch.from_numpy(v))
                           for k, v in jax_shards.items()
                           if k.startswith(name + "/") and k.endswith("/full"))
    shape = {"data": 2, "model": 4}
    specs = {"train": lambda: tspecs.param_specs(cfg, full, shape, "train"),
             "decode": lambda: tspecs.param_specs(cfg, full, shape, "decode"),
             "opt": lambda: tspecs.opt_state_specs(cfg, full, None, shape),
             "cache": lambda: tspecs.cache_specs(cfg, full, shape, long_context=True)}[name]()
    spec_of = dict(tree_paths(specs))
    cut = {len([e for e in s if e]) for s in spec_of.values()}
    assert 1 in cut, "no leaf is cut"
    for path, leaf in tree_paths(full):
        for i in range(2):
            for j in range(4):
                got = layout.local_shard(leaf, spec_of[path], _StandIn(shape, (i, j)))
                want = jax_shards[f"{name}/{'/'.join(path)}/{i}{j}"]
                assert got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{path} at {i, j}")


def test_a_two_axis_entry_is_cut_data_major():
    x = torch.arange(16.0).reshape(8, 2)
    spec = tspecs.Spec(("data", "model"))
    shape = {"data": 2, "model": 4}
    got = [layout.local_shard(x, spec, _StandIn(shape, (i, j)))[:, 0].tolist()
           for i in range(2) for j in range(4)]
    assert got == [[2.0 * r] for r in range(8)]
    assert layout.full_shape((1, 2), spec, _StandIn(shape, (0, 0))) == (8, 2)
    with pytest.raises(ValueError, match="does not split"):
        layout.local_shard(torch.zeros(6, 2), spec, _StandIn(shape, (0, 0)))
