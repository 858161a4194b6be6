"""The port's serving slice (repro_torch.launch) against the JAX package,
and the port's independence from JAX.

The JAX reference is built from ``make_prefill_step`` / ``make_serve_step``
jitted without a sharding context, and from a hand-written loop that
mirrors ``repro.launch.serve.Server`` (whose own constructor needs a mesh
that this JAX version rejects, ROADMAP hazard 1).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.launch import steps as jsteps
import repro_torch.configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.params import from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3-8b"
# the port's entry points beside the JAX package's examples
EXAMPLES = ("train_100m_torch.py", "serve_batched_torch.py", "quickstart_torch.py",
            "collective_sweep_torch.py", "multipod_dryrun_torch.py")
# each example's arguments on the CPU: the costing examples allocate nothing
# on any device and take no --device
EXAMPLE_ARGV = {"serve_batched_torch.py": ["--device", "cpu"],
                "quickstart_torch.py": ["--device", "cpu"],
                "collective_sweep_torch.py": [], "multipod_dryrun_torch.py": []}


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype="float32")
    jp = jax.jit(lambda k: jmodels.init_params(jcfg, k))(jax.random.PRNGKey(3))
    tp = from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def test_prefill_then_serve_steps_give_the_jax_greedy_ids(setup):
    jcfg, tcfg, jp, tp = setup
    B, S, steps, max_len = 3, 29, 8, 40
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S))
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, kv_max=max_len))
    jserve = jax.jit(jsteps.make_serve_step(jcfg))
    tok, cache = jprefill(jp, {"tokens": jnp.asarray(toks)})
    want = [np.asarray(tok)]
    for i in range(steps):
        tok, cache = jserve(jp, cache, tok, jnp.int32(S + i + 1))
        want.append(np.asarray(tok))

    tprefill = tsteps.make_prefill_step(tcfg, kv_max=max_len)
    tserve_step = tsteps.make_serve_step(tcfg)
    tok, cache = tprefill(tp, {"tokens": torch.from_numpy(toks)})
    got = [tok.numpy()]
    for i in range(steps):
        tok, cache = tserve_step(tp, cache, tok, S + i + 1)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))
    assert cache["b0_dense"]["k"].shape[2] == max_len


def _jax_server_loop(jcfg, jp, prompts, max_batch, max_len, rounds):
    """repro.launch.serve.Server.admit / decode_round (serve.py:67-91),
    written out without its sharding context."""
    step = jax.jit(jsteps.make_serve_step(jcfg))
    cache = jmodels.init_cache(jcfg, max_batch, max_len)
    tokens = jnp.zeros((max_batch, 1), jnp.int32)
    cur_len = 0
    generated = [[] for _ in prompts]
    for i, prompt in enumerate(prompts):          # slot i is the first free
        for t in prompt:
            tok = tokens.at[i, 0].set(int(t))
            cur_len = max(cur_len + 1, len(prompt))
            nxt, cache = step(jp, cache, tok, jnp.int32(cur_len))
            tokens = tokens.at[i, 0].set(int(nxt[i, 0]))
    for _ in range(rounds):
        cur_len += 1
        nxt, cache = step(jp, cache, tokens, jnp.int32(cur_len))
        tokens = nxt
        for i in range(len(prompts)):
            generated[i].append(int(nxt[i, 0]))
    return generated, np.asarray(tokens), cur_len


def test_server_matches_the_jax_server_loop(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, jcfg.vocab_size, size=n) for n in (6, 3, 9)]
    max_batch, max_len, rounds = 4, 48, 6
    want, want_tokens, want_len = _jax_server_loop(jcfg, jp, prompts,
                                                   max_batch, max_len, rounds)
    srv = tserve.Server(tcfg, max_batch=max_batch, max_len=max_len,
                        device="cpu")
    srv.params = tp
    for rid, p in enumerate(prompts):
        assert srv.admit(rid, p)
    for _ in range(rounds):
        srv.decode_round()
    assert srv.cur_len == want_len
    assert [s.generated for s in srv.slots[:len(prompts)]] == want
    assert srv.slots[-1].done and srv.active() == len(prompts)
    np.testing.assert_array_equal(srv.tokens.numpy(), want_tokens)


def test_server_and_cli_refuse_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    cfg = tconfigs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.Server(cfg)
    argv = ["--arch", ARCH, "--smoke", "--n-requests", "2", "--max-new", "2",
            "--max-len", "32"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(argv)
    tserve.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("OK")


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(m == 'repro' or m.startswith(('repro.', 'jax')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print(' '.join(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    assert len(names) >= 15
    assert {"repro_torch.models.moe", "repro_torch.configs.mixtral_8x7b",
            "repro_torch.configs.llama4_maverick",
            "repro_torch.configs.whisper_large_v3",
            "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
            "repro_torch.optim.clip", "repro_torch.optim.schedule",
            "repro_torch.checkpoint.ckpt", "repro_torch.data.pipeline",
            "repro_torch.runtime.fault_tolerance", "repro_torch.runtime.straggler",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.sharding.ctx", "repro_torch.sharding.layout",
            "repro_torch.sharding.specs", "repro_torch.runtime.compression",
            "repro_torch.launch.pipeline", "repro_torch.launch.cost",
            "repro_torch.launch.dryrun", "repro_torch.launch.collective_capture",
            "repro_torch.launch.roofline", "repro_torch.launch.input_specs",
            "repro_torch.core", "repro_torch.core.energy", "repro_torch.core.interconnect",
            "repro_torch.core.partition", "repro_torch.core.noc", "repro_torch.core.mapping",
            "repro_torch.core.scheduling", "repro_torch.core.ccpg",
            "repro_torch.core.timeline", "repro_torch.core.simulator"} <= set(names)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    port = len(files)
    files += [ROOT / "chip_smoke.py"] + [ROOT / "examples" / f for f in EXAMPLES]
    assert port > 15 and all(f.exists() for f in files)
    rel = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files[:port]}
    assert {"optim/adamw.py", "optim/adafactor.py", "optim/clip.py", "optim/schedule.py",
            "checkpoint/ckpt.py", "data/pipeline.py", "runtime/fault_tolerance.py",
            "runtime/straggler.py", "launch/train.py", "launch/mesh.py",
            "sharding/ctx.py", "sharding/layout.py", "sharding/specs.py",
            "runtime/compression.py", "launch/pipeline.py", "launch/cost.py",
            "launch/dryrun.py", "launch/collective_capture.py", "launch/roofline.py",
            "launch/input_specs.py", "core/simulator.py", "core/timeline.py"} <= rel
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {mod}"


@pytest.mark.parametrize("example", ["serve_batched_torch.py", "quickstart_torch.py",
                                     "collective_sweep_torch.py", "multipod_dryrun_torch.py"])
def test_example_runs_on_the_cpu_with_jax_blocked(example):
    """The example, with ``--device cpu`` where it takes one, in a process
    where ``jax`` cannot be imported: exit 0, ``OK`` last."""
    path = str(ROOT / "examples" / example)
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            f"sys.argv = {[path] + EXAMPLE_ARGV[example]!r}\n"
            f"runpy.run_path({path!r}, run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "OK", r.stdout[-2000:]
