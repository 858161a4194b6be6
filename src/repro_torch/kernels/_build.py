"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use by ``nvcc`` into a shared
library with a plain C interface, in ``build/repro_torch_kernels/`` at the
root of the checkout (git-ignored), and loaded with ``ctypes``.  A
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  A source named
in ``PARTS`` is compiled as several translation units in parallel, one per
set of ``-D`` flags besides the one without them, and linked into its one
library.  Nothing is compiled when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# the sources compiled in parts: the -D flags of each part (the file's own
# comment says what each part holds); ptxas takes minutes over the flash
# backward's kernels in one process
PARTS = {"flash_attention_bwd": [[f"-DFLASH_BWD_PART={i}"] for i in range(1, 9)]}

_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int
# C entry point of each source: (name, argtypes); each returns cudaError_t
SIGNATURES = {
    "flash_attention": ("flash_attention_fwd",
                        [_VOID_P] * 5 + [_INT] * 11 + [_VOID_P, _VOID_P]),
    "flash_attention_bwd": ("flash_attention_bwd", [_VOID_P] * 10 + [_INT] * 11 + [_VOID_P]),
    "paged_attention": ("paged_attention_fwd",
                        [_VOID_P] * 7 + [_INT] * 13 + [_VOID_P, _VOID_P]),
    "ssd_scan": ("ssd_scan_fwd", [_VOID_P] * 7 + [_INT] * 8 + [_VOID_P]),
    "ssd_scan_bwd": ("ssd_scan_bwd", [_VOID_P] * 15 + [_INT] * 8 + [_VOID_P]),
    "pwl_softmax": ("pwl_softmax_fwd", [_VOID_P] * 2 + [_INT] * 5 + [_VOID_P, _VOID_P]),
    "cim_matmul": ("cim_matmul_fwd", [_VOID_P] * 8 + [_INT] * 10 + [_VOID_P]),
}

# kernel launches per source, counted by the launching wrapper, and per
# (source, shape key) for the wrappers that give a key (``launch_key``)
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
LAUNCHES_BY_SHAPE: Dict[Tuple[str, str], int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}
# seconds from the start of the last ``build_all`` until each ``nvcc`` of a
# library ended, in the order of its translation units (the source as it
# is, then each part); the link not counted
BUILD_SECONDS: Dict[str, list] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha1((" ".join(NVCC_FLAGS) + repr(PARTS)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def start(src: Path, out: Path, parts=()):
    """Start compiling ``src`` into the library ``out``: one ``nvcc``, or,
    with ``parts`` (lists of -D flags), one ``nvcc -c`` for the source as
    it is and one for each part, all started together.  Returns
    ``finish``, which waits, links the parts, and returns (ok, log);
    ``finish.procs`` are the ``nvcc`` processes.  Their output goes to
    files beside ``out``, so no process waits on a full pipe."""
    logs = []

    def run(args):
        logs.append(out.with_suffix(f".{len(logs)}.log"))
        with open(logs[-1], "w") as f:
            return subprocess.Popen([nvcc(), *args], stdout=f, stderr=subprocess.STDOUT)
    if not parts:
        procs, objs = [run([*NVCC_FLAGS, "-o", str(out), str(src)])], []
    else:
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        objs = [out.with_suffix(f".{i}.o") for i in range(len(parts) + 1)]
        procs = [run([*compile_flags, *flags, "-c", "-o", str(obj), str(src)])
                 for flags, obj in zip([[]] + list(parts), objs)]

    def finish():
        for p in procs:
            p.wait()
        log = "".join(f.read_text() for f in logs)
        for f in logs:
            f.unlink(missing_ok=True)
        ok = not any(p.returncode for p in procs)
        if ok and objs:
            link = subprocess.run([nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(out),
                                   *map(str, objs)], capture_output=True, text=True)
            log += link.stdout + link.stderr
            ok = link.returncode == 0
        for obj in objs:
            obj.unlink(missing_ok=True)
        return ok, log
    finish.procs = procs
    return finish


def build_all(names=None) -> Dict[str, Path]:
    """Compile the named sources (default: every ``csrc/*.cu``) that are
    not built yet, one ``nvcc`` per source or part, all started together."""
    names = sorted(names or (p.stem for p in CSRC.glob("*.cu")))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, start(CSRC / f"{n}.cu", tmp, PARTS.get(n, ())))
    t0 = time.time()
    ends = {n: [None] * len(finish.procs) for n, (_, finish) in procs.items()}
    while any(None in e for e in ends.values()):
        for n, (_, finish) in procs.items():
            for i, p in enumerate(finish.procs):
                if ends[n][i] is None and p.poll() is not None:
                    ends[n][i] = round(time.time() - t0, 1)
        time.sleep(0.2)
    BUILD_SECONDS.clear()
    BUILD_SECONDS.update(ends)
    failed = []
    for n, (tmp, finish) in procs.items():
        ok, BUILD_LOGS[n] = finish()
        # C7514: ptxas serialized wgmma.mma_async, a correct but several
        # times slower kernel; refused like a failed build
        if not ok or "C7514" in BUILD_LOGS[n]:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("nvcc failed or serialized wgmma (C7514) for " + ", ".join(failed)
                           + ":\n"
                           + "\n".join(BUILD_LOGS[n] for n in failed))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        so = build_all([name])[name]
        lib = ctypes.CDLL(str(so))
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _INT
        _LIBS[name] = lib
    return lib


def aligned(t):
    """``t`` contiguous, starting on a 16-byte boundary, for kernels that
    copy rows 16 bytes at a time (a fresh allocation is aligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_grad(name: str, missing: str, *tensors) -> None:
    """Raise ``NotImplementedError`` where autograd would need the backward
    of kernel ``name`` (grad enabled, an input that requires grad) and the
    port has none: the kernel's output would carry no gradient.
    ``missing`` names the ROADMAP item that would add it."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward kernel for this call "
                                  f"({missing}); its output would carry no gradient")


def check(err: int, name: str, shape: str = "") -> None:
    """Raise if a C entry point returned a CUDA error (its launch check);
    else count the launch, also under ``shape`` where one is given."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    if shape:
        key = (name, shape)
        LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
