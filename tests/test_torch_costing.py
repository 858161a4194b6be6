"""The port's dry-run costing (``repro_torch.launch``: ``cost``,
``roofline``, ``input_specs``, ``dryrun``, ``collective_capture``) and its
copy of the PICNIC core, against the JAX package on the CPU.

A fake world (``torch.distributed``'s ``"fake"`` backend) needs a process
of its own, so the fake-world cases run in subprocesses, started together
with one JAX subprocess (8 host devices, ``Auto`` axes: hazard 1) that
compiles the reference's side: a tensor-parallel matmul on 4 devices, the
llama3.2-1b smoke prefill and train step on one, and the ``picnic``
capture of the same smoke cell on ``1x8``."""
import ast
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
from repro.launch import hlo_cost
from repro.launch import roofline as jroofline
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
from repro_torch.kernels.cim_matmul import cim_work
from repro_torch.kernels.flash_attention import bwd_work, fwd_work, kept_pairs
from repro_torch.kernels.paged_attention import paged_work
from repro_torch.kernels.pwl_softmax import softmax_work
from repro_torch.kernels.ssd_scan import ssd_bwd_work, ssd_work
from repro_torch.launch import collective_capture as tcc
from repro_torch.launch import cost
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import roofline as troofline
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
CORE = ("energy", "interconnect", "partition", "noc", "mapping", "scheduling", "ccpg",
        "timeline", "simulator")
ARCH = "llama3.2-1b"
# the model-FLOPs cell: S above 1024, where the reference's forward takes its
# blockwise attention (512-row chunks, the last one padded)
FLOPS_B, FLOPS_S = 1, 1280

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import json, sys
sys.path.insert(0, {src!r})
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro import models, optim
from repro.configs import ShapeSpec, get_smoke_config
from repro.launch import dryrun, hlo_cost
from repro.launch.steps import make_prefill_step, make_train_step
out = {{}}
mesh4 = jax.make_mesh((4,), ("model",), devices=jax.devices()[:4],
                      axis_types=(AxisType.Auto,))
w = jax.ShapeDtypeStruct((512, 512), jnp.bfloat16)
x = jax.ShapeDtypeStruct((64, 512), jnp.bfloat16)
fn = jax.jit(lambda w, x: x @ w, in_shardings=(NamedSharding(mesh4, P("model", None)),
                                               NamedSharding(mesh4, P())),
             out_shardings=NamedSharding(mesh4, P()))
c = hlo_cost.analyze(fn.lower(w, x).compile().as_text(), 4)
out["tp"] = {{"flops": c.flops, "coll": c.coll}}
cfg = get_smoke_config({arch!r})
tok = jax.ShapeDtypeStruct(({B}, {S}), jnp.int32)
pshapes = jax.eval_shape(lambda: models.init_params(cfg, jax.random.PRNGKey(0)))
c = jax.jit(make_prefill_step(cfg, kv_max={S})).lower(pshapes, {{"tokens": tok}}).compile()
out["prefill_flops"] = hlo_cost.analyze(c.as_text(), 1).flops
oshapes = jax.eval_shape(optim.make_optimizer(cfg.optimizer)[0], pshapes)
c = jax.jit(make_train_step(cfg)).lower(pshapes, oshapes,
                                        {{"tokens": tok, "labels": tok}}).compile()
out["train_flops"] = hlo_cost.analyze(c.as_text(), 1).flops
mesh8 = jax.make_mesh((1, 8), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for mode in ("prefill", "decode"):
    fn, args = dryrun.build_cell(cfg, ShapeSpec(f"{{mode}}_512", 512, 1, mode), mesh8,
                                 opt_variant="picnic")
    out["capture_" + mode] = hlo_cost.analyze(fn.lower(*args).compile().as_text(), 8).coll
print(json.dumps(out))
"""

PRELUDE = """
import json, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
out = {{}}
"""

# a tensor-parallel matmul on a fake world of 4: x (64, 512) replicated,
# w (512, 512) cut over its rows; each rank multiplies its columns of x by
# its rows of w into a float32 partial product, which an all-reduce sums (the
# program the reference's HLO runs); then a world of another size is refused
WORLD4 = PRELUDE + """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import collective_capture, cost
from repro_torch.launch.input_specs import fake_mode
dryrun.fake_world(4)
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
with fake_mode():
    x = torch.empty(64, 512, dtype=torch.bfloat16)
    w_local = torch.empty(128, 512, dtype=torch.bfloat16)

def tp(x, w_local):
    i = mesh.get_local_rank("model")
    part = x[:, 128 * i:128 * (i + 1)].float() @ w_local.float()
    torch.distributed.all_reduce(part, group=mesh.get_group("model"))
    return part.to(torch.bfloat16)

def loop(x, w):
    y = x
    for _ in range(10):
        y = torch.tanh(y @ w)
    return y

c = cost.analyze(tp, x, w_local)
out["tp"] = {{"flops": c.flops, "coll": c.coll}}
with fake_mode():
    w = torch.empty(512, 512, dtype=torch.bfloat16)
out["loop_flops"] = cost.analyze(loop, x, w).flops
refused = []
for call in (lambda: dryrun.fake_world(8),
             lambda: collective_capture.capture_cell({arch!r}, mesh="1x8", smoke=True)):
    try:
        call()
    except ValueError as e:
        refused.append(str(e))
out["refused"] = refused
print(json.dumps(out))
"""

# llama3.2-1b on the single-pod mesh (256 fake ranks): the smoke config in
# every mode, baseline and picnic, and decode_32k at full size
POD1 = PRELUDE + """
import math
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import input_specs as ispec
from repro_torch.sharding import specs as sp
recs = {{}}
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    for variant in ("baseline", "picnic"):
        recs[f"{{shape}}/{{variant}}"] = dryrun.run_cell({arch!r}, shape, "pod1", variant,
                                                      save=False, smoke=True)
recs["full"] = dryrun.run_cell({arch!r}, "decode_32k", "pod1", "baseline", save=False)
cfg, shape = get_config({arch!r}), SHAPES["decode_32k"]
ms = {{"data": 16, "model": 16}}

def shard_bytes(t, spec):
    div = math.prod(math.prod(ms[a] for a in e) for e in spec if e)
    return t.numel() * t.element_size() // div

p = ispec.params_shapes(cfg)
token, cache, _ = ispec.decode_arg_specs(cfg, shape)
pspecs = sp.param_specs(cfg, p, ms, "decode")
cspecs = sp.cache_specs(cfg, cache, ms)
tspec = sp.batch_specs(cfg, {{"token": token}}, ms)["token"]
from repro_torch.tree import tree_paths
expect = sum(shard_bytes(t, s) for (_, t), (_, s) in zip(tree_paths(p), tree_paths(pspecs)))
expect += sum(shard_bytes(t, s) for (_, t), (_, s) in zip(tree_paths(cache), tree_paths(cspecs)))
out["recs"] = recs
out["argument_bytes"] = expect + shard_bytes(token, tspec)
print(json.dumps(out, default=str))
"""

PP = PRELUDE + """
out["pp"] = dryrun.run_cell({arch!r}, "train_4k", "2x2x2", "pp", save=False, smoke=True)
print(json.dumps(out, default=str))
"""


def _start(code: str, env=None):
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _finish(p, what: str):
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, f"{what}:\n{err[-4000:]}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """Every subprocess of this file, started together: the JAX reference,
    three fake worlds of the port's, and ``capture_in_subprocess``."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    fmt = dict(src=SRC, arch=ARCH, B=FLOPS_B, S=FLOPS_S)
    procs = {"ref": _start(REFERENCE.format(**fmt), env),
             "world4": _start(WORLD4.format(**fmt), env),
             "pod1": _start(POD1.format(**fmt), env),
             "pp": _start(PP.format(**fmt), env)}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        capture = ex.submit(tcc.capture_in_subprocess, ARCH, modes=("prefill", "decode"),
                            mesh="1x8", variant="picnic", smoke=True, timeout=600)
        out = {name: _finish(p, name) for name, p in procs.items()}
        out["capture"] = capture.result()
    return out


# ---- configs and the core copy -----------------------------------------------

def test_shapes_and_arch_lists_equal_the_reference():
    assert tconfigs.SHAPES.keys() == jconfigs.SHAPES.keys()
    for name, s in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == dataclasses.asdict(s)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.PAPER_ARCHS == jconfigs.PAPER_ARCHS


def _body_without_imports(path: Path) -> str:
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return ast.dump(tree)


@pytest.mark.parametrize("module", CORE)
def test_core_module_is_the_reference_apart_from_imports(module):
    ours = ROOT / "src" / "repro_torch" / "core" / f"{module}.py"
    theirs = ROOT / "src" / "repro" / "core" / f"{module}.py"
    assert _body_without_imports(ours) == _body_without_imports(theirs)


def test_core_exports_what_its_modules_define():
    for name in ("PicnicSimulator", "comparison_table", "MeasuredTraffic", "Timeline",
                 "CCPGModel", "TileSpec", "Mesh2D", "allocate_chiplets"):
        assert getattr(tcore, name).__module__.startswith("repro_torch.core")
    assert tcore.PLATFORMS == jcore.PLATFORMS
    assert not hasattr(tcore, "ProgramBuilder") and not hasattr(tcore, "SCUFsm")


def _measured(core):
    return core.MeasuredTraffic(prefill_bytes=3.0e6, decode_bytes_per_token=1234.0,
                                per_collective={"all-reduce": {"count": 6.0, "bytes": 10.0,
                                                               "wire_bytes": 8.0}},
                                n_devices=8, source="c10d:test")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama3-8b", "llama2-13b"])
@pytest.mark.parametrize("mode", ["plain", "ccpg", "measured"])
def test_simulator_equals_the_reference_field_for_field(arch, mode):
    kw = {"plain": {}, "ccpg": {"ccpg": True}}.get(mode)
    ours = tcore.PicnicSimulator().run(tconfigs.get_config(arch), 1024, 1024,
                                       **(kw if kw is not None
                                          else {"measured_c2c": _measured(tcore)}))
    theirs = jcore.PicnicSimulator().run(jconfigs.get_config(arch), 1024, 1024,
                                         **(kw if kw is not None
                                            else {"measured_c2c": _measured(jcore)}))
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert tcore.comparison_table(ours) == jcore.comparison_table(theirs)


# the simulator cases of tests/test_collective_capture.py, on the port's copy

def _rec(mode, wire_total, batch, coll=None):
    return {"arch": "x", "mode": mode, "seq_len": 512, "batch": batch,
            "mesh": {"data": 1, "model": 8}, "nchips": 8,
            "variant": "picnic", "smoke": True, "compile_s": 0.0,
            "collectives": coll or {}, "wire_bytes_per_chip": wire_total / 8,
            "wire_bytes_total": wire_total, "flops_per_chip": 0.0,
            "xla_flops": 0.0}


def test_parse_mesh_as_the_reference():
    assert tcc.parse_mesh("2x4") == ((2, 4), ("data", "model"))
    assert tcc.parse_mesh("2x2x2") == ((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError):
        tcc.parse_mesh("8")


def test_to_measured_traffic_normalizes_per_request():
    coll = {"all-reduce": {"count": 4.0, "bytes": 10.0, "wire_bytes": 8.0}}
    mt = tcc.to_measured_traffic(_rec("prefill", 4000.0, batch=4),
                                 _rec("decode", 800.0, batch=4, coll=coll))
    assert mt.prefill_bytes == 1000.0
    assert mt.decode_bytes_per_token == 200.0
    assert mt.per_collective["all-reduce"]["wire_bytes"] == 8.0
    assert mt.n_devices == 8 and mt.source.startswith("c10d")
    assert isinstance(mt, tcore.MeasuredTraffic)


def test_to_measured_traffic_without_prefill():
    mt = tcc.to_measured_traffic(None, _rec("decode", 80.0, batch=1))
    assert mt.prefill_bytes == 0.0
    assert mt.decode_bytes_per_token == 80.0


def test_simulator_measured_c2c_flag():
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    sim = tcore.PicnicSimulator()
    base = sim.run(cfg, 128, 128)
    mt = tcore.MeasuredTraffic(prefill_bytes=1e6, decode_bytes_per_token=100.0,
                               source="c10d:test")
    meas = sim.run(cfg, 128, 128, measured_c2c=mt)
    assert meas.throughput_tps == base.throughput_tps
    assert meas.c2c_bytes_total == int(1e6) + 100 * 128
    assert meas.c2c_source == "c10d:test"
    assert meas.c2c_avg_power_W >= base.c2c_avg_power_W


def test_simulator_default_path_untouched():
    cfg = tconfigs.get_smoke_config("llama3.2-1b")
    sim = tcore.PicnicSimulator()
    a, b = sim.run(cfg, 128, 128), sim.run(cfg, 128, 128)
    assert a == b
    assert a.c2c_source == "analytic"


# ---- the roofline ----------------------------------------------------------------

MESHES = {"pod1": {"data": 16, "model": 16}, "pod2": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_analytic_roofline_is_bit_equal_to_the_reference(arch):
    ours, theirs = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for name in jconfigs.SHAPES:
        t_shape, j_shape = tconfigs.SHAPES[name], jconfigs.SHAPES[name]
        assert troofline.model_flops(ours, t_shape) == jroofline.model_flops(theirs, j_shape)
        for B, S in ((t_shape.global_batch, t_shape.seq_len), (3, 1000)):
            assert troofline._cache_bytes(ours, B, S) == jroofline._cache_bytes(theirs, B, S)
        for mesh in MESHES.values():
            for mode in ("train", "prefill", "decode"):
                assert (troofline.analytic_memory_bytes(ours, t_shape, mesh, mode)
                        == jroofline.analytic_memory_bytes(theirs, j_shape, mesh, mode))


def test_roofline_terms_use_the_h100_peaks():
    terms = troofline.roofline_terms(989e12, 3.35e12, 450e9)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert troofline.roofline_terms(67e12, 0, 0, "float32")["compute_s"] == 1.0
    assert troofline.dominant_term({"compute_s": 1, "memory_s": 3, "collective_s": 2}) \
        == "memory_s"


# ---- the counter ---------------------------------------------------------------

def _fake(shape, dtype=torch.bfloat16, grad=False):
    with ispec.fake_mode():
        return torch.empty(shape, dtype=dtype).requires_grad_(grad)


def test_one_matmul_counts_exactly():
    c = cost.analyze(lambda x, w: x @ w, _fake((64, 512)), _fake((512, 512)))
    assert c.flops == 2 * 64 * 512 * 512
    assert c.bytes == (64 * 512 + 512 * 512 + 64 * 512) * 2
    assert c.coll == {} and c.kernels == {} and c.flop_counter == c.flops
    x, w = torch.randn(64, 512), torch.randn(512, 512)        # real tensors alike
    assert cost.analyze(lambda x, w: x @ w, x, w).flops == 2 * 64 * 512 * 512


def test_a_backward_counts_its_matmuls():
    x, w = _fake((64, 512), grad=True), _fake((512, 256), grad=True)
    c = cost.analyze(lambda x, w: (x @ w).sum().backward(), x, w)
    assert c.flops == 3 * 2 * 64 * 512 * 256


@pytest.mark.parametrize("op", ["all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                                "collective-permute"])
@pytest.mark.parametrize("groups", ["replica_groups=[2,4]<=[8]",
                                    "replica_groups={{0,1},{2,3},{4,5},{6,7}}", ""])
def test_ring_rules_equal_hlo_cost(op, groups):
    inst = hlo_cost.Instr("c", "f32[64,512]", op, [], groups)
    want = hlo_cost.Cost()
    hlo_cost._collective_cost(inst, hlo_cost.Computation("e"), 8, want)
    g = {"replica_groups=[2,4]<=[8]": 4, "": 8}.get(groups, 2)
    logical, wire = cost.ring_wire(op, 64 * 512 * 4, g)
    assert want.coll[op] == {"count": 1.0, "bytes": logical, "wire_bytes": wire}


def test_ring_wire_refuses_an_unknown_op():
    with pytest.raises(ValueError):
        cost.ring_wire("broadcast", 8, 2)


def test_counting_is_not_reentrant_and_unhooks():
    from repro_torch.kernels import ops
    with cost.count():
        with pytest.raises(RuntimeError):
            with cost.count():
                pass
    assert ops.COUNTER is None


def test_kernel_calls_are_counted_by_their_rules_not_their_plain_arithmetic():
    from repro_torch.kernels import ops
    b, s, hq, hkv, d = 2, 96, 4, 2, 32
    q, k, v = (_fake((b, s, h, d), grad=True) for h in (hq, hkv, hkv))

    def step(q, k, v):
        ops.flash_attention(q, k, v, window=40).float().sum().backward()
    c = cost.analyze(step, q, k, v)
    fwd = fwd_work(b, s, s, hq, hkv, d, 2, True, 40, lse=True)
    bwd = bwd_work(b, s, s, hq, hkv, d, 2, True, 40)
    assert c.kernels == {"flash_attention": {"launches": 1, "flops": fwd[1], "bytes": fwd[0]},
                         "flash_attention_bwd": {"launches": 1, "flops": bwd[1],
                                                 "bytes": bwd[0]}}
    assert c.kernel_flops == fwd[1] + bwd[1] == c.flops
    # real tensors: the plain versions' outputs, the same count
    qr, kr, vr = (torch.randn(t.shape).to(torch.bfloat16).requires_grad_(True)
                  for t in (q, k, v))
    cr = cost.analyze(step, qr, kr, vr)
    assert cr.kernels == c.kernels and qr.grad is not None and kr.grad.abs().sum() > 0


def test_counting_refuses_a_kernel_call_on_a_tensor_off_the_cpu():
    from repro_torch.kernels import ops
    q = torch.empty((1, 8, 2, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="flash_attention is counted on fake or CPU"):
        cost.analyze(lambda q: ops.flash_attention(q, q, q), q)
    assert ops.COUNTER is None
    # beside fake tensors, a real one off the CPU (a block table kept from
    # an earlier run on the card) is read for its shape only
    from repro_torch.kernels.paged_attention import identity_block_table
    table = identity_block_table(2, 64, 16).to("meta")
    fq, pool = _fake((2, 4, 32)), _fake((8, 16, 2, 32))
    lens = ispec.fake_mode().from_tensor(torch.tensor([64, 64], dtype=torch.int32))
    c = cost.analyze(lambda *a: ops.paged_attention(*a), fq, pool, pool, table, lens)
    assert c.kernels["paged_attention"]["launches"] == 1


def test_counting_leaves_the_kernel_calls_of_other_threads_alone():
    import threading
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 24, 2, 16), generator=gen)
    got = {}
    other = threading.Thread(target=lambda: got.update(out=ops.flash_attention(q, q, q)))
    with cost.count() as c:
        other.start()
        other.join()
    assert c.kernels == {}
    assert torch.equal(got["out"], flash_attention_plain(q, q, q))


def test_paged_rule_keeps_the_keys_of_the_lengths():
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import identity_block_table
    B, H, Hkv, D, bt, max_len = 3, 4, 2, 32, 16, 64
    q = torch.randn(B, H, D)
    pool = torch.randn(B * max_len // bt, bt, Hkv, D)
    table = identity_block_table(B, max_len, bt)
    lens = torch.tensor([5, 64, 30], dtype=torch.int32)
    c = cost.analyze(lambda *a: ops.paged_attention(*a, window=20), q, pool, pool, table, lens)
    kept = 5 + 20 + 20
    assert c.kernels["paged_attention"]["flops"] == paged_work(q, pool, table, kept)[1]
    c = cost.analyze(lambda *a: ops.paged_attention_partial(*a, key_offset=32), q, pool, pool,
                     table, lens)
    kept = 0 + 32 + 0
    nbytes, flops = paged_work(q, pool, table, kept, partial=True)
    assert c.kernels["paged_attention"] == {"launches": 1, "flops": flops, "bytes": nbytes}


def test_ssd_softmax_and_cim_calls_count_by_their_rules():
    from repro_torch.kernels import ops
    b, S, H, P, N = 2, 40, 3, 8, 4
    x = torch.randn(b, S, H, P, requires_grad=True)
    dt = torch.rand(b, S, H, requires_grad=True)
    a_neg = -torch.rand(H, requires_grad=True)
    B, C = (torch.randn(b, S, N, requires_grad=True) for _ in range(2))

    def scan(*a):
        y, state = ops.ssd_scan(*a, chunk=16)
        (y.sum() + state.sum()).backward()
    c = cost.analyze(scan, x, dt, a_neg, B, C)
    fwd, bwd = ssd_work(b, S, H, P, N, 4), ssd_bwd_work(b, S, H, P, N, 4, True)
    assert c.kernels == {"ssd_scan": {"launches": 1, "flops": fwd[1], "bytes": fwd[0]},
                         "ssd_scan_bwd": {"launches": 1, "flops": bwd[1], "bytes": bwd[0]}}
    assert x.grad is not None and B.grad.abs().sum() > 0
    s_in = _fake((6, 300), torch.float32)
    c = cost.analyze(ops.pwl_softmax, s_in)
    assert c.kernels["pwl_softmax"] == {"launches": 1, "flops": softmax_work(s_in)[1],
                                        "bytes": softmax_work(s_in)[0]}
    xq, w = _fake((128, 512)), _fake((512, 256), torch.float32)
    c = cost.analyze(lambda a, b: ops.cim_matmul(a, b), xq, w)
    nbytes, i8, f32 = cim_work(xq, torch.empty(512, 256, dtype=torch.int8),
                               torch.empty(2, 256))
    assert c.kernels["cim_matmul"] == {"launches": 1, "flops": i8 + f32, "bytes": nbytes}


def test_cost_scales_and_merges_as_the_reference():
    a = cost.Cost(10.0, 20.0, peak_bytes=5.0)
    a.add_coll("all-reduce", 8.0, 14.0, 1)
    a.add_kernel("paged_attention", 4.0, 6.0)
    b = a.scaled(3)
    assert (b.flops, b.bytes, b.peak_bytes) == (48.0, 72.0, 5.0)
    assert b.coll["all-reduce"] == {"count": 3.0, "bytes": 24.0, "wire_bytes": 42.0}
    assert b.kernels["paged_attention"] == {"launches": 3, "flops": 18.0, "bytes": 12.0}
    a.merge(b)
    assert a.wire_bytes == 56.0 and a.launches == {"paged_attention": 4}
    assert a.kernel_flops == 24.0 and a.flops == 64.0


def test_kernel_rules_give_the_published_bounds():
    """The rules moved out of chip_smoke.py give its former bounds at the
    PERF.md §6 main-path shapes (ms, to the five places printed there)."""
    meta = dict(device="meta")
    q = torch.empty(4, 32, 128, dtype=torch.bfloat16, **meta)
    pool = torch.empty(36, 64, 8, 128, dtype=torch.bfloat16, **meta)
    table = torch.empty(4, 9, dtype=torch.int32, **meta)
    # chip_smoke's former inline flash and paged work at llama3-8b's shapes
    b, s, hq, hkv, d = 4, 512, 32, 8, 128
    assert fwd_work(b, s, s, hq, hkv, d, 2) == (
        (2 * b * s * hq * d + 2 * b * s * hkv * d) * 2, 4 * b * hq * d * s * (s + 1) / 2)
    ctx = 4 * 544
    assert paged_work(q, pool, table, ctx) == (
        2 * q.numel() * 2 + 2 * ctx * hkv * d * 2 + table.numel() * 4 + 4 * 4,
        4 * ctx * hq * d)
    x = torch.empty(2048, 4096, dtype=torch.bfloat16, **meta)
    wq = torch.empty(4096, 14336, dtype=torch.int8, **meta)
    ws = torch.empty(16, 14336, **meta)
    nb, i8, f32 = cim_work(x, wq, ws)
    cases = [
        (fwd_work(b, s, s, hq, hkv, d, 2), "bfloat16", 0.01252),
        (fwd_work(1, 4160, 4160, 32, 8, 128, 2, True, 4096), "bfloat16", 0.14334),
        (fwd_work(4, 1500, 1500, 20, 20, 64, 2, False), "bfloat16", 0.04659),
        (paged_work(q, pool, table, ctx), "bfloat16", 0.00268),
        (ssd_work(4, 512, 80, 64, 128, 2), "bfloat16", 0.02242),
        (ssd_work(8, 1024, 80, 64, 128, 2), "bfloat16", 0.08342),
        (bwd_work(8, 1024, 1024, 32, 8, 64, 2), "bfloat16", 0.08694),
        (ssd_bwd_work(8, 1024, 80, 64, 128, 2, False), "bfloat16", 0.15431),
        (softmax_work(torch.empty(4 * 32 * 512, 512, dtype=torch.bfloat16, **meta)),
         "float32", 0.04006),
        ((nb, i8), "int8", 0.12154),
    ]
    for (nbytes, flops), dt, want in cases:
        assert round(troofline.bound(nbytes, flops, dt)[0], 5) == want
    assert round(f32 / (troofline.PEAK_FLOPS["float32"] / 2) * 1e3, 5) == 0.12620
    assert kept_pairs(4, 10, True, 2, 0, 3) == 8


# ---- the model and the reference's HLO --------------------------------------------

def _reference_attention_dots(cfg, B, S, passes):
    """The reference's attention dot FLOPs: two dots a (query, key) pair of
    its blocks, every block the masks cut computed whole: one S x S block
    at S <= 1024 (``full_attention``), else 512-row chunks, the last
    padded; ``passes`` 1 (prefill) or 3 (train: + four backward dots)."""
    chunk = S if S <= 1024 else 512
    padded = -(-S // chunk) * chunk
    return passes * 2 * 2 * B * cfg.n_heads * padded * padded * cfg.head_dim * cfg.n_layers


def test_matmul_flops_without_attention_equal_the_reference(runs):
    cfg = tconfigs.get_smoke_config(ARCH)
    jcfg = jconfigs.get_smoke_config(ARCH)
    shape = tconfigs.ShapeSpec("x", FLOPS_S, FLOPS_B, "prefill")
    p = ispec.params_shapes(cfg)
    pre = cost.analyze(make_prefill_step(cfg, kv_max=FLOPS_S), p,
                       ispec.prefill_batch_specs(cfg, shape))
    with ispec.fake_mode():
        pg = tree_map(lambda t: t.requires_grad_(True), ispec.params_shapes(cfg))
        o = make_optimizer(cfg.optimizer)[0](pg)
    train = cost.analyze(make_train_step(cfg), pg, o, ispec.train_batch_specs(cfg, shape))
    assert pre.launches == {"flash_attention": cfg.n_layers}
    assert train.launches == {"flash_attention": cfg.n_layers,
                              "flash_attention_bwd": cfg.n_layers}
    for ours, theirs, passes in ((pre, runs["ref"]["prefill_flops"], 1),
                                 (train, runs["ref"]["train_flops"], 3)):
        want = theirs - _reference_attention_dots(jcfg, FLOPS_B, FLOPS_S, passes)
        got = ours.flops - ours.kernel_flops
        print(f"matmul FLOPs without attention: port {got:.6e}, reference {want:.6e}")
        assert abs(got / want - 1) < 0.01


# ---- fake worlds ------------------------------------------------------------------

def test_tensor_parallel_matmul_matches_hlo_cost(runs):
    ours, theirs = runs["world4"]["tp"], runs["ref"]["tp"]
    assert ours["flops"] == 2 * 64 * 512 * 512 / 4 == theirs["flops"]
    assert ours["coll"] == theirs["coll"]
    assert ours["coll"]["all-reduce"]["wire_bytes"] == 2 * 3 / 4 * 64 * 512 * 4


def test_a_loop_of_ten_matmuls_counts_ten(runs):
    assert runs["world4"]["loop_flops"] == 10 * 2 * 64 * 512 * 512


def test_a_second_fake_world_of_another_size_is_refused(runs):
    refused = runs["world4"]["refused"]
    assert len(refused) == 2 and all("world of 4 ranks" in r for r in refused)


def _reference_record_keys(func: str, call: str):
    """The keys of the record that ``func`` of the reference's
    ``launch/<call>.py`` returns: its dict literal (``rec = {...}`` or
    ``return {...}``) and the keywords of ``rec.update(...)``."""
    tree = ast.parse((ROOT / "src" / "repro" / "launch" / f"{call}.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    keys = set()
    for node in ast.walk(fn):
        value = node.value if isinstance(node, (ast.Assign, ast.Return)) else None
        if isinstance(value, ast.Dict) and (isinstance(node, ast.Return)
                                            or node.targets[0].id == "rec"):
            keys |= {k.value for k in value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "update":
            keys |= {kw.arg for kw in node.keywords}
    return keys


def test_capture_records_have_the_reference_keys_and_exact_combine_bytes(runs):
    pre, dec = runs["capture"]
    keys = _reference_record_keys("capture_cell", "collective_capture")
    assert set(pre) == set(dec) == keys
    assert (pre["mode"], dec["mode"]) == ("prefill", "decode")
    cfg = tconfigs.get_smoke_config(ARCH)
    g, B, H, D = 8, 1, cfg.n_heads, cfg.head_dim
    # the port's combine: m by MAX, then o and l by SUM, each attention layer
    per_layer = [B * H * 4, B * H * D * 4, B * H * 4]
    want = sum(2 * (g - 1) / g * n for n in per_layer) * cfg.n_layers
    assert dec["collectives"]["all-reduce"]["count"] == 3 * cfg.n_layers
    assert dec["collectives"]["all-reduce"]["wire_bytes"] == want
    others = sum(d["wire_bytes"] for op, d in dec["collectives"].items() if op != "all-reduce")
    assert dec["wire_bytes_per_chip"] == want + others
    assert dec["wire_bytes_total"] == dec["wire_bytes_per_chip"] * 8
    for mode, rec in (("prefill", pre), ("decode", dec)):
        ref = runs["ref"]["capture_" + mode]
        for op in sorted(set(ref) | set(rec["collectives"])):
            mine = rec["collectives"].get(op, {"count": 0, "wire_bytes": 0})
            theirs = ref.get(op, {"count": 0, "wire_bytes": 0})
            print(f"{ARCH} smoke 1x8 picnic {mode} {op}: port {int(mine['count'])} x, "
                  f"{mine['wire_bytes']:.0f} B; reference {int(theirs['count'])} x, "
                  f"{theirs['wire_bytes']:.0f} B")


def test_dry_run_cells_end_ok(runs):
    recs = runs["pod1"]["recs"]
    keys = (_reference_record_keys("run_cell", "dryrun")
            - {"lower_s", "compile_s", "xla_cost_analysis", "reason", "error", "traceback"}
            | {"count_s", "rank", "flop_counter", "kernels"})
    for name, rec in list(recs.items()) + [("pp", runs["pp"]["pp"])]:
        assert rec["status"] == "ok", (name, rec.get("traceback"))
        assert set(rec) == keys, name
        assert rec["flops_per_chip"] > 0 and rec["memory"]["temp_bytes"] > 0
        assert rec["memory"]["code_bytes"] is None
    cfg = tconfigs.get_smoke_config(ARCH)
    assert recs["decode_32k/picnic"]["collectives"]["all-reduce"]["count"] == 3 * cfg.n_layers
    assert "all-reduce" not in recs["decode_32k/baseline"]["collectives"]
    assert recs["train_4k/baseline"]["kernels"]["flash_attention_bwd"]["launches"] \
        == cfg.n_layers
    pp = runs["pp"]["pp"]
    assert pp["nchips"] == 8 and pp["rank"] == 4         # the last stage counts more


def test_full_size_decode_cell_holds_its_local_shards(runs):
    rec = runs["pod1"]["recs"]["full"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["nchips"] == 256
    assert rec["memory"]["argument_bytes"] == runs["pod1"]["argument_bytes"]
    cfg = tconfigs.get_config(ARCH)
    assert rec["kernels"]["paged_attention"]["launches"] == cfg.n_layers
    assert rec["model_flops_per_chip"] == troofline.model_flops(
        cfg, tconfigs.SHAPES["decode_32k"]) / 256
