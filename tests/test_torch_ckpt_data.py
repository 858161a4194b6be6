"""The port's checkpoints, data pipeline, runtime copies and train driver
against the JAX package's: a checkpoint written by either package restores
bit for bit in the other (bf16 included); the port's own copies of
``repro.data.pipeline``, ``repro.runtime.fault_tolerance`` and
``repro.runtime.straggler`` behave as the originals on the same calls; and
``repro_torch.launch.train`` restarts from a checkpoint and lowers the
loss on the CPU."""
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.data as jdata
import repro.runtime.fault_tolerance as jft
import repro.runtime.straggler as jst
import repro_torch.checkpoint as tckpt
import repro_torch.data as tdata
import repro_torch.runtime as trt
from repro_torch.launch import train as ttrain


def _trees():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    e = rng.standard_normal((5, 2)).astype(np.float32)
    jt = ({"layers": {"wq": jnp.asarray(w), "norm": jnp.asarray(e[0])},
           "embed": jnp.asarray(e).astype(jnp.bfloat16)},
          {"m": {"a": jnp.zeros((2,), jnp.float32)}, "step": jnp.asarray(7, jnp.int32)})
    tt = ({"embed": torch.from_numpy(e).to(torch.bfloat16),
           "layers": {"norm": torch.from_numpy(e[0].copy()), "wq": torch.from_numpy(w)}},
          {"step": torch.tensor(7, dtype=torch.int32), "m": {"a": torch.zeros(2)}})
    return jt, tt


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(t_tree, j_tree):
    tl = [x for x in jax.tree_util.tree_leaves(j_tree)]
    from repro_torch.checkpoint.ckpt import _flatten_with_names
    names, leaves = _flatten_with_names(t_tree)
    assert len(leaves) == len(tl)
    for n, a, b in zip(names, leaves, tl):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=n)
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype), n


def test_port_checkpoint_restores_bit_equal_in_jax_and_back(tmp_path):
    jt, tt = _trees()
    tckpt.save(tmp_path / "t", 3, tt, {"step": 3, "data_state": {"doc_index": 2, "carry": [5]}})
    out, extras = jckpt.restore(tmp_path / "t", jax.tree.map(np.asarray, jt))
    _assert_bit_equal(tt, out)
    assert extras == {"step": 3, "data_state": {"doc_index": 2, "carry": [5]}}
    # and the reverse: JAX writes, the port restores onto its tree
    jckpt.save(tmp_path / "j", 4, jt, {"step": 4})
    like = jax.tree.map(lambda x: x, tt)
    got, extras = tckpt.restore(tmp_path / "j", like)
    _assert_bit_equal(got, jt)
    assert extras == {"step": 4} and list(got[0]) == list(tt[0])
    # the manifests are the same but for the time
    mt = json.loads((tmp_path / "t" / "step_000000003" / "manifest.json").read_text())
    mj = json.loads((tmp_path / "j" / "step_000000004" / "manifest.json").read_text())
    for k in ("names", "shapes", "dtypes"):
        assert mt[k] == mj[k], k


def test_restore_checks_shapes_and_casts_to_the_target(tmp_path):
    _, tt = _trees()
    tckpt.save(tmp_path, 1, tt)
    like = ({"embed": torch.zeros((5, 2)), "layers": {"norm": torch.zeros(2),
                                                      "wq": torch.zeros((3, 4))}},
            {"step": torch.tensor(0, dtype=torch.int32), "m": {"a": torch.zeros(2)}})
    got, _ = tckpt.restore(tmp_path, like)
    assert got[0]["embed"].dtype == torch.float32
    assert torch.equal(got[0]["embed"], tt[0]["embed"].float())
    like[0]["layers"]["wq"] = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path, like)
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(tmp_path, {"other": torch.zeros(1)})


def test_checkpoint_needs_only_numpy_and_json_to_read(tmp_path):
    _, tt = _trees()
    d = tckpt.save(tmp_path, 2, tt, {"step": 2})
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz", allow_pickle=False) as data:
        kinds = {data[f].dtype.kind for f in data.files}
        assert len(data.files) == len(manifest["names"])
        for i, dt in enumerate(manifest["dtypes"]):
            a = data[f"a{i}"]
            assert list(a.shape) == manifest["shapes"][i]
            # bf16 is stored as its uint16 bits (the reference's convention)
            assert a.dtype == (np.uint16 if dt == "bfloat16" else np.dtype(dt))
    assert kinds <= {"f", "i", "u", "b"}                 # no void / object arrays
    assert sorted(p.name for p in d.iterdir()) == [".complete", "arrays.npz", "manifest.json"]
    # a reader with numpy and json alone (jax and ml_dtypes blocked) decodes
    # every leaf, bf16 from its uint16 bits
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        f"d = {str(d)!r}\n"
        "m = json.load(open(d + '/manifest.json'))\n"
        "with np.load(d + '/arrays.npz', allow_pickle=False) as z:\n"
        "    for i, dt in enumerate(m['dtypes']):\n"
        "        a = z[f'a{i}']\n"
        "        if dt == 'bfloat16':\n"
        "            a = (a.astype(np.uint32) << 16).view(np.float32)\n"
        "        print(m['names'][i], a.dtype, float(a.astype(np.float64).sum()))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    sums = {line.split()[0]: float(line.split()[2]) for line in r.stdout.splitlines()}
    from repro_torch.checkpoint.ckpt import _flatten_with_names
    for name, leaf in zip(*_flatten_with_names(tt)):
        assert sums[name] == pytest.approx(float(leaf.double().sum()), abs=1e-6), name


def test_latest_step_ignores_an_incomplete_checkpoint_and_gc_keeps_the_newest(tmp_path):
    _, tt = _trees()
    for s in (1, 2, 3, 4):
        tckpt.save(tmp_path, s, tt)
    (tmp_path / "step_000000009").mkdir()                # no .complete: a crash mid-write
    assert tckpt.latest_step(tmp_path) == 4 == jckpt.latest_step(tmp_path)
    tckpt.gc_old(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003", "step_000000004", "step_000000009"]
    assert tckpt.latest_step(tmp_path / "missing") is None


def test_async_checkpointer_copies_at_save_and_applies_back_pressure(tmp_path, monkeypatch):
    import repro_torch.checkpoint.ckpt as ck
    real_save, order = ck.save, []

    def slow_save(d, step, tree, extras=None):
        order.append(("start", step))
        time.sleep(0.2)
        out = real_save(d, step, tree, extras)
        order.append(("end", step))
        return out
    monkeypatch.setattr(ck, "save", slow_save)
    c = ck.AsyncCheckpointer(tmp_path, keep=2)
    _, tt = _trees()
    c.save(1, tt)
    tt[0]["layers"]["wq"].add_(1.0)                      # after the synchronous copy
    c.save(2, tt)                                        # waits for write 1 first
    assert order[:2] == [("start", 1), ("end", 1)]
    c.save(3, tt)
    c.wait()
    assert [s for _, s in order] == [1, 1, 2, 2, 3, 3]
    assert tckpt.latest_step(tmp_path) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000002", "step_000000003"]
    _, orig = _trees()
    got, _ = tckpt.restore(tmp_path, orig, step=2)
    assert torch.equal(got[0]["layers"]["wq"], orig[0]["layers"]["wq"] + 1)


def test_packed_stream_and_tokenizer_match_the_original():
    for seed, vocab, seq in ((0, 512, 64), (3, 128256, 33)):
        js, ts = jdata.PackedStream(vocab, seq, seed=seed), tdata.PackedStream(vocab, seq, seed=seed)
        for _ in range(3):
            a, b = js.next_batch(3), ts.next_batch(3)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        snap = ts.snapshot()
        assert snap == js.snapshot()
        want = [ts.next_batch(2) for _ in range(2)]
        fresh = tdata.PackedStream(vocab, seq, seed=seed)
        fresh.restore(snap)
        for w in want:
            got = fresh.next_batch(2)
            for k in w:
                np.testing.assert_array_equal(got[k], w[k])
    jt, tt = jdata.ByteTokenizer(), tdata.ByteTokenizer()
    ids = tt.encode("héllo, wörld")
    np.testing.assert_array_equal(ids, jt.encode("héllo, wörld"))
    assert tt.decode(ids) == jt.decode(ids) == "héllo, wörld"
    jd, td = jdata.synthetic_documents(5, 300), tdata.synthetic_documents(5, 300)
    for _ in range(4):
        np.testing.assert_array_equal(next(jd), next(td))

    class Cfg:
        vocab_size = 300
    ja, ta = jdata.make_train_batches(Cfg, 16, 2, seed=1), tdata.make_train_batches(Cfg, 16, 2, seed=1)
    for _ in range(2):
        np.testing.assert_array_equal(next(ja)["tokens"], next(ta)["tokens"])


def test_restart_policy_heartbeats_and_stragglers_match_the_originals():
    jp, tp = jft.RestartPolicy(max_restarts=3, window_s=10.0), trt.RestartPolicy(
        max_restarts=3, window_s=10.0)
    for now in (0.0, 1.0, 2.0, 5.0, 11.5, 12.0, 30.0):
        assert tp.should_restart(now) == jp.should_restart(now)
        assert tp.next_backoff(now) == jp.next_backoff(now)
        tp.record_failure(now)
        jp.record_failure(now)
        assert tp.history == jp.history
    e = trt.WorkerFailure(3, "(injected)")
    assert str(e) == str(jft.WorkerFailure(3, "(injected)")) and e.worker_id == 3
    assert isinstance(e, RuntimeError)

    clock = {"t": 0.0}
    jm = jft.HeartbeatMonitor(3, 2.0, 5.0, clock=lambda: clock["t"])
    tm = trt.HeartbeatMonitor(3, 2.0, 5.0, clock=lambda: clock["t"])
    for t, beat in ((1.0, 0), (3.0, 1), (4.0, None), (7.5, 1), (9.0, 2)):
        clock["t"] = t
        for m in (jm, tm):
            if beat is not None:
                m.heartbeat(beat)
        assert tm.sweep() == jm.sweep()
        assert tm.healthy_ids() == jm.healthy_ids()
        assert [w.state.value for w in tm.workers.values()] == \
            [w.state.value for w in jm.workers.values()]
    for n in (1, 2, 5):
        assert trt.plan_elastic_mesh(n) == jft.plan_elastic_mesh(n)

    jd, td = jst.StragglerDetector(4, min_samples=3), trt.StragglerDetector(4, min_samples=3)
    rng = np.random.default_rng(0)
    for i in range(12):
        for w in range(4):
            dt = float(rng.uniform(0.9, 1.1)) * (3.0 if w == 2 and i > 4 else 1.0)
            jd.record(w, dt)
            td.record(w, dt)
        assert [(r.worker_id, r.ewma_s, r.fleet_median_s, r.slowdown) for r in td.stragglers()] \
            == [(r.worker_id, r.ewma_s, r.fleet_median_s, r.slowdown) for r in jd.stragglers()]
    assert [r.worker_id for r in td.stragglers()] == [2]
    jb, tb = jst.BackupInputRunner(jd), trt.BackupInputRunner(td)
    for w, pt, bt in ((2, 3.0, 1.0), (1, 1.0, 0.5), (2, 0.5, 1.0)):
        assert tb.fetch(w, lambda: "p", lambda: "b", pt, bt) == \
            jb.fetch(w, lambda: "p", lambda: "b", pt, bt)
    assert (tb.speculated, tb.wins_by_backup) == (jb.speculated, jb.wins_by_backup)


def test_train_driver_restarts_from_a_checkpoint_and_lowers_the_loss(tmp_path, capsys):
    losses = ttrain.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                          "--steps", "12", "--simulate-failures", "1", "--save-every", "4",
                          "--batch", "2", "--seq-len", "64", "--log-every", "4",
                          "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[ft] restarted from step 4" in out
    assert losses[-1] < losses[0]
    assert tckpt.latest_step(tmp_path) == 12
    # a second run resumes from the step-12 checkpoint and its data cursor
    losses2 = ttrain.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                           "--steps", "20", "--save-every", "100", "--batch", "2",
                           "--seq-len", "64", "--ckpt-dir", str(tmp_path)])
    assert "restored from checkpoint at step 12" in capsys.readouterr().out
    assert len(losses2) == 8


def test_train_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)])
