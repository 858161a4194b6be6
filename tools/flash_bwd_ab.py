#!/usr/bin/env python3
"""Time the flash backward kernel of two source trees in one process on one
card, in turns (a, b, b, a), at the port's train shapes.

  python3 tools/flash_bwd_ab.py --a PARENT_CHECKOUT [--b .]

Each tree's ``src/repro_torch/csrc/flash_attention_bwd.cu`` is compiled with
the port's nvcc flags (in parts where the source is written in parts,
``_build.PARTS``; both trees at once) into its own library under ``build/``
and called
through its C entry ``flash_attention_bwd`` (the same signature in both) on
the same inputs; the forward (lse, out) comes from this tree's package.
Prints per shape the median ms of each tree over its two turns, CUDA
events over 20 launches, L2 flushed before each, and whether the two
trees' gradients are bit-equal.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# B, S, Hq, Hkv, D, causal, window, prefix: llama3.2-1b, whisper's encoder,
# zamba2, mixtral's train shapes; llama3.2-1b's without the mask (every tile
# kept whole) and at S 64 (every tile on the diagonal); llama3-8b's B4 S512
# D128; paligemma's train shape B4 S1280 Hq8 Hkv1 D256 with its prefix of
# 256 and without it (a tree without D 256 or the prefix refuses those)
SHAPES = [(8, 1024, 32, 8, 64, True, 0, 0), (8, 1500, 20, 20, 64, False, 0, 0),
          (8, 1024, 32, 32, 80, True, 0, 0), (2, 4160, 32, 8, 128, True, 4096, 0),
          (8, 1024, 32, 8, 64, False, 0, 0), (128, 64, 32, 8, 64, True, 0, 0),
          (4, 512, 32, 8, 128, True, 0, 0), (4, 1280, 8, 1, 256, True, 0, 256),
          (4, 1280, 8, 1, 256, True, 0, 0)]


def build(trees) -> dict:
    """{tag: the loaded library of tree ``trees[tag]``}, built together."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    finish = {}
    for tag, tree in trees.items():
        out = ROOT / "build" / "ab" / f"flash_attention_bwd_{tag}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        src = tree / "src" / "repro_torch" / "csrc" / "flash_attention_bwd.cu"
        parts = _build.PARTS["flash_attention_bwd"] if "FLASH_BWD_PART" in src.read_text() \
            else ()
        finish[tag] = (out, _build.start(src, out, parts))
    libs = {}
    for tag, (out, done) in finish.items():
        ok, log = done()
        if not ok:
            raise RuntimeError(f"nvcc failed for tree {tag}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11 + \
            [ctypes.c_void_p]
        lib.flash_attention_bwd.restype = ctypes.c_int
        libs[tag] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True, help="the first tree (e.g. the parent commit)")
    ap.add_argument("--b", default=str(ROOT), help="the second tree (default: this one)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import flash_attention as fa
    libs = build({"a": Path(args.a).resolve(), "b": Path(args.b).resolve()})
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, s, hq, hkv, d, causal, window, prefix in SHAPES:
        q = torch.randn((b, s, hq, d), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        g = torch.randn_like(q)
        out, lse = fa._flash_fwd(q, k, v, causal=causal, use_pwl=False, window=window,
                                 prefix_len=prefix, with_lse=True)
        grads = {tag: tuple(torch.empty_like(t) for t in (q, k, v)) for tag in libs}
        delta = torch.empty((b, hq, s), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch(tag):
            dq, dk, dv = grads[tag]
            return libs[tag].flash_attention_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                b, s, s, hq, hkv, d, 1, int(causal), window, prefix, 0, stream)

        times = {tag: [] for tag in libs}
        takes = {tag: launch(tag) == 0 for tag in libs}        # a tree may refuse the mode
        if not takes["b"]:
            raise RuntimeError("tree b refuses a train shape")
        for tag in ("a", "b", "b", "a"):
            if not takes[tag]:
                continue
            launch(tag)                                   # warm-up
            total = 0.0
            for _ in range(20):
                flush.zero_()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                launch(tag)
                end.record()
                torch.cuda.synchronize()
                total += start.elapsed_time(end)
            times[tag].append(total / 20)
        shape = (f"B{b} S{s} Hq{hq} Hkv{hkv} D{d} causal={int(causal)} window={window} "
                 f"prefix={prefix}")
        b_ms = f"b {sum(times['b']) / 2:.4f} ms ({times['b'][0]:.4f}, {times['b'][1]:.4f})"
        if not takes["a"]:
            print(f"{shape}: a refuses the mode, {b_ms}", flush=True)
            continue
        same = all(torch.equal(x, y) for x, y in zip(grads["a"], grads["b"]))
        print(f"{shape}: a {sum(times['a']) / 2:.4f} ms ({times['a'][0]:.4f}, "
              f"{times['a'][1]:.4f}), {b_ms}, gradients bit-equal: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
