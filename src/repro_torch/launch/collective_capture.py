"""Measure photonic-link traffic from the collectives the port issues.

Port of ``repro.launch.collective_capture``: the TP x SP x PP prefill /
decode / train cells run once on fake tensors over a fake process group
(``dryrun.build_cell``, ``launch.cost``: no device allocation), the
per-collective ring-model wire bytes of the ``c10d`` ops the port's step
issues are counted, and the totals are packaged as a
:class:`repro_torch.core.interconnect.MeasuredTraffic` that
``PicnicSimulator.run(..., measured_c2c=...)`` consumes as the photonic
C2C traffic term.  The default simulator path stays analytic.

One process holds one fake world (``dryrun.fake_world``): ``capture_cell``
makes it when there is none and refuses a world of another size;
``capture_in_subprocess`` runs each capture in a fresh process, as the
reference does for its forced host device count.  A record has the
reference's keys; ``compile_s`` holds the seconds of the counted run
(nothing is compiled) and ``xla_flops`` ``FlopCounterMode``'s total.

CLI:

  PYTHONPATH=src python -m repro_torch.launch.collective_capture \\
      --arch llama3.2-1b --mesh 1x8 --seq 512 --batch 1 --variant picnic
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Dict, List, Optional, Sequence

from repro_torch.core.interconnect import MeasuredTraffic

_DEF_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def parse_mesh(spec: str):
    """"1x8" -> data×model; "2x2x2" -> pod×data×model (sizes per axis)."""
    sizes = tuple(int(s) for s in spec.lower().split("x"))
    if len(sizes) not in _DEF_AXES:
        raise ValueError(f"mesh spec {spec!r}: want 2 (data x model) or "
                         "3 (pod x data x model) factors")
    return sizes, _DEF_AXES[len(sizes)]


def capture_cell(arch: str, *, mode: str = "decode", seq_len: int = 512,
                 batch: int = 1, mesh: str = "1x8",
                 variant: str = "picnic", smoke: bool = False) -> Dict:
    """Run one (arch, mode, mesh) cell on fake tensors and return a record
    with the per-collective measured wire bytes of one rank (rank 0; the
    ``pp`` cell the stage that counts more).

    ``mode``: "decode" (one sharded decode step against a ``seq_len``
    cache), "prefill" (prompt of ``seq_len``), or "train".  ``variant`` is
    a ``dryrun.build_cell`` opt_variant ("picnic" turns on the port's
    sequence-parallel attention / partial-softmax decode paths; "pp" is the
    GPipe cell and needs a 3-factor mesh).  ``smoke`` uses the CPU-sized
    config."""
    from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
    from repro_torch.launch import dryrun

    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    sizes, axes = parse_mesh(mesh)
    shape = ShapeSpec(f"{mode}_{seq_len}", seq_len, batch, mode)
    c, _, _, seconds, _ = dryrun.cost_cell(cfg, shape, mesh, variant)
    nchips = 1
    for n in sizes:
        nchips *= n
    wire_per_chip = c.wire_bytes
    return {
        "arch": arch, "mode": mode, "seq_len": seq_len, "batch": batch,
        "mesh": dict(zip(axes, sizes)), "nchips": nchips,
        "variant": variant, "smoke": smoke,
        "compile_s": round(seconds, 2),
        "collectives": c.coll,                   # per chip, per step
        "wire_bytes_per_chip": wire_per_chip,
        "wire_bytes_total": wire_per_chip * nchips,
        "flops_per_chip": c.flops,
        "xla_flops": float(c.flop_counter),
    }


def to_measured_traffic(prefill_rec: Optional[Dict],
                        decode_rec: Dict) -> MeasuredTraffic:
    """Capture records -> the simulator's photonic traffic term.

    Totals are normalized PER REQUEST (divide by the captured batch) so
    they compose with the simulator's single-stream (b=1) Table II walk:
    decode bytes are per generated token, prefill bytes per prompt.
    """
    dec_per_tok = decode_rec["wire_bytes_total"] / max(decode_rec["batch"], 1)
    pre = 0.0
    if prefill_rec is not None:
        pre = prefill_rec["wire_bytes_total"] / max(prefill_rec["batch"], 1)
    return MeasuredTraffic(
        prefill_bytes=pre,
        decode_bytes_per_token=dec_per_tok,
        per_collective=decode_rec["collectives"],
        n_devices=decode_rec["nchips"],
        source=f"c10d:{decode_rec['mesh']}")


def capture_in_subprocess(arch: str, *, modes: Sequence[str] = ("prefill",
                                                               "decode"),
                          seq_len: int = 512, batch: int = 1,
                          mesh: str = "1x8", variant: str = "picnic",
                          smoke: bool = False, timeout: int = 1200) -> List[Dict]:
    """Run the capture CLI in a fresh process (a process holds one fake
    world, which an already-running process, e.g. one with a world of its
    own, cannot make anew)."""
    env = dict(os.environ)
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.collective_capture",
           "--arch", arch, "--modes", ",".join(modes),
           "--seq", str(seq_len), "--batch", str(batch),
           "--mesh", mesh, "--variant", variant, "--json"]
    if smoke:
        cmd.append("--smoke")
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"collective capture failed:\n{r.stderr[-3000:]}")
    return json.loads(r.stdout)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--modes", default="prefill,decode",
                    help="comma list of prefill|decode|train")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--mesh", default="1x8",
                    help='"DxM" (data x model) or "PxDxM" (pod first)')
    ap.add_argument("--variant", default="picnic")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable records on stdout (logs -> "
                         "stderr)")
    args = ap.parse_args()

    recs = []
    for mode in args.modes.split(","):
        rec = capture_cell(args.arch, mode=mode.strip(), seq_len=args.seq,
                           batch=args.batch, mesh=args.mesh,
                           variant=args.variant, smoke=args.smoke)
        recs.append(rec)
        log = sys.stderr if args.json else sys.stdout
        print(f"[{rec['mode']:7s}] {rec['arch']} mesh={rec['mesh']} "
              f"count={rec['compile_s']}s wire/chip="
              f"{rec['wire_bytes_per_chip']:.3e}B", file=log, flush=True)
        for op, d in sorted(rec["collectives"].items()):
            print(f"    {op:20s} count={int(d['count']):6d} "
                  f"wire={d['wire_bytes']:.3e}B", file=log, flush=True)
    if args.json:
        print(json.dumps(recs))


if __name__ == "__main__":
    main()
