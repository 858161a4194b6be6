"""Multi-pod dry-run walk-through for ONE cell on the PyTorch port: yi-34b
decode_32k on the 512-rank mesh, baseline and picnic, run once on fake
tensors over a fake world (``repro_torch.launch.dryrun``), with the
memory, the counted cost and the H100 roofline terms printed -- what the
full sweep does for every cell.  The port's counterpart of
``examples/multipod_dryrun.py``.  Nothing is allocated on any device, so
it runs the same on any host.  Ends with ``OK``.

  PYTHONPATH=src python examples/multipod_dryrun_torch.py [arch] [shape]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    from repro_torch.launch.dryrun import run_cell

    arch = argv[0] if len(argv) > 0 else "yi-34b"
    shape = argv[1] if len(argv) > 1 else "decode_32k"

    for mesh, variant in [("pod2", "baseline"), ("pod2", "picnic")]:
        rec = run_cell(arch, shape, mesh, variant, save=False)
        print(f"\n=== {rec['cell']} [{variant}] -> {rec['status']} ===")
        if rec["status"] != "ok":
            raise RuntimeError(rec.get("reason") or rec.get("traceback"))
        m = rec["memory"]
        print(f"ranks: {rec['nchips']}  counted in: {rec['count_s']}s")
        print(f"per-rank residency (args): {m['argument_bytes']/1e9:.2f} GB, "
              f"peak live {m['temp_bytes']/1e9:.2f} GB")
        print(f"flops/rank: {rec['flops_per_chip']:.3e} "
              f"(useful fraction {rec['useful_flop_frac']:.2f})")
        print("kernels:", {k: int(v["launches"]) for k, v in rec["kernels"].items()})
        print("roofline terms (s):",
              {k: round(v, 5) for k, v in rec["roofline"].items()},
              "->", rec["dominant"])
        print("collectives:", {k: (int(v['count']), f"{v['wire_bytes']:.2e}B")
                               for k, v in rec["collectives"].items()})
    print("OK")


if __name__ == "__main__":
    main()
